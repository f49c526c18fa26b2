"""The flagship U-Net: config, parameter init and the folded-BN forward."""

from tpu_unet_torch.models.infer import fold_bn, unet_infer_apply
from tpu_unet_torch.models.unet import Params, State, UNetConfig, init_unet, param_count

__all__ = ["Params", "State", "UNetConfig", "fold_bn", "init_unet", "param_count",
           "unet_infer_apply"]
