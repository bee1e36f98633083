from dmvsnet_tpu_torch.fusion.pcd import pcd_filter  # noqa: F401
from dmvsnet_tpu_torch.fusion.dypcd import dypcd_filter  # noqa: F401
from dmvsnet_tpu_torch.fusion.tank_config import TANK_SCENE_CONFIG  # noqa: F401
