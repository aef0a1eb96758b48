"""The encoder towers: ViT (DINO and CLIP visual, and with a linear
classifier), the CLIP text tower, the CLIP tokenizer, the ResNet towers
(the two-head ResNet-18 of the AutoNovel baseline and the BN-folded
ResNet-50 feature extractor), their checkpoint loaders and the
parameter-tree bridge."""

from scd_tpu_torch.models.clip import (  # noqa: F401
    CLIPConfig,
    CLIPModel,
    TextTransformer,
    clip_vit_b16_config,
    load_openai_clip_weights,
)
from scd_tpu_torch.models.dino import (  # noqa: F401
    dino_vit_b16_config,
    dino_vit_s16_config,
    dino_vit_t16_config,
    load_dino_weights,
)
from scd_tpu_torch.models.params import params_from_flax  # noqa: F401
from scd_tpu_torch.models.resnet import ResNetTwoHead  # noqa: F401
from scd_tpu_torch.models.resnet50 import (  # noqa: F401
    ResNet50,
    ResNet50Config,
    load_resnet50_weights,
)
from scd_tpu_torch.models.tokenizer import CLIPTokenizer  # noqa: F401
from scd_tpu_torch.models.vit import (  # noqa: F401
    Int8Dense,
    ViTConfig,
    VisionTransformer,
    VisionTransformerWithLinear,
    interpolate_pos_embed,
    seq_pad_target,
)
