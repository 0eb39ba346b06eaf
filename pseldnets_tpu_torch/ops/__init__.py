"""Feature frontend and the kernel wrappers, one module per kernel: K1
``frontend`` (the radix-2 frontend), K2 ``swin_block`` (Swin block), K3
``swin_block_vjp`` (its backward), K4/K5 ``swin_block_adapt`` (the Swin block
with adapters and its backward), K6 ``vit_block`` (PaSST ViT block), K7
``conv_block`` (CNN 3x3 ConvBlock), K8 ``patch_embed`` (HTSAT patch embed),
K9/K10 ``frontend_forms`` (the frontend's flat and DIF forms), K11
``swin_stage`` (a whole eval Swin stage in one launch)."""
