from dmvsnet_tpu_torch.losses.mvs_loss import mvs_loss  # noqa: F401
from dmvsnet_tpu_torch.losses import metrics  # noqa: F401
