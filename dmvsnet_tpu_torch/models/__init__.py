from dmvsnet_tpu_torch.models.mvsnet import MVSNet  # noqa: F401
from dmvsnet_tpu_torch.models.feature_net import FeatureNet  # noqa: F401
from dmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetRefine  # noqa: F401
