"""Fused-kernel eval forwards."""

from .crnn import crnn_fused_forward  # noqa: F401
from .crnn import crnn_fused_forward_from_wav  # noqa: F401
from .crnn import prepare_crnn  # noqa: F401
from .einv2 import einv2_htsat_fused_forward  # noqa: F401
from .einv2 import einv2_htsat_fused_forward_from_wav  # noqa: F401
from .einv2 import prepare_einv2  # noqa: F401
from .htsat import embed_tokens  # noqa: F401
from .htsat import folded_wav_features  # noqa: F401
from .htsat import htsat_fused_forward  # noqa: F401
from .htsat import htsat_fused_forward_from_wav  # noqa: F401
from .htsat import prepare_blocks  # noqa: F401
from .htsat import prepare_patch_embed  # noqa: F401
from .htsat import prepare_stages  # noqa: F401
from .htsat import scalar_bn_affine  # noqa: F401
from .passt import passt_fused_forward  # noqa: F401
from .passt import passt_fused_forward_from_wav  # noqa: F401
from .passt import prepare_vit_blocks  # noqa: F401
