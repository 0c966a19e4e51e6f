from orbit2_tpu_torch.models.res_slimvit import ResSlimViT
from orbit2_tpu_torch.models.baselines import Climatology, Interpolation, LinearRegression, Persistence
from orbit2_tpu_torch.models.resnet import ResNet
from orbit2_tpu_torch.models.unet import Unet
from orbit2_tpu_torch.models.vit import VisionTransformer
