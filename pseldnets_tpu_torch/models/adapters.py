"""AdapterBit bottleneck adapters and LoRA layers in PyTorch, the
counterpart of the JAX package's models/adapters.py (``Adapter`` :30-53,
``AdaptDense`` :56-81, ``AdaptConv`` :84-121, ``AdaptConfig`` :124-200).

Parity target: reference src/models/components/model_utilities_adapt.py.
An ``Adapter`` is a bottleneck MLP: fc1 (C -> C * mlp_ratio) -> activation
(exact erf GELU, ReLU or tanh) -> fc2 (-> C), times a constant scalar or a
learnable one. It sits parallel to the Swin block's MLP ("MlpAdapter",
models/common.py::Mlp, with an optional second bottleneck ``adapter_ds``,
``new_adapter``) and after the attention projection ("SpatialAdapter",
models/htsat.py::WindowAttention). Its fc2 starts at zero (flax
``kernel_init=zeros``), so a fresh adapter is an identity residual.

LoRA (``method`` containing "lora", configs/adapt/lora.yaml) adds a
low-rank term to the HTSAT's linears (qkv, proj, the MLP's fc1/fc2, the
merges' reduction: ``AdaptDense``) and to its patch embed (``AdaptConv``),
scaled by lora_alpha / r, with ``lora_B`` starting at zero. As in the JAX
package, the forward always computes base + LoRA (no merge into the base
weight) and freezing is the optimizer's (train/optim.py); ``lora_dropout``,
``fan_in_fan_out`` and ``merge_weights`` are read by neither package.

The kernels (K2-K5, K8, K11) run constant-scalar GELU adapters without
``new_adapter`` and no LoRA (``kernel_refusal``, the one statement of that
rule); every other setting trains and evaluates on the eager modules, as the
JAX package routes it (its train/module.py:337-374).
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LEARNABLE = "learnable_scalar"

_ACTS = {"gelu": lambda x: F.gelu(x, approximate="none"), "relu": F.relu, "tanh": torch.tanh}


class Adapter(nn.Module):
    """Bottleneck adapter ``fc2(act(fc1 x)) * scale``. Parameter names
    fc1/fc2 are the reference's torch keys. ``adapter_scalar`` is a constant
    (``scale`` a float, as the JAX Adapter's ``float(adapter_scalar)``) or
    "learnable_scalar": then ``scale`` is None and the learnable scale, ones
    of shape (1,), is the parameter ``weight`` (the key the JAX package's key
    map gives its flax ``scale``, as for a LayerNorm's)."""

    def __init__(self, dim: int, mlp_ratio: float, adapter_scalar=LEARNABLE,
                 act_layer: str = "gelu"):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.act_layer = str(act_layer).lower()
        if self.act_layer not in _ACTS:
            raise KeyError(f"act_layer {act_layer!r}: the adapters take {sorted(_ACTS)}")
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        if adapter_scalar == LEARNABLE:
            self.scale = None
            self.weight = nn.Parameter(torch.ones(1))
        else:
            self.scale = float(adapter_scalar)
        with torch.no_grad():  # zero-init up-projection (adapters.py:45-47)
            self.fc2.weight.zero_()
            self.fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(_ACTS[self.act_layer](self.fc1(x)))
        return h * (self.weight if self.scale is None else self.scale)


class AdaptDense(nn.Linear):
    """nn.Linear with an optional LoRA term, rank ``r`` and scaling
    lora_alpha / r: ``linear(x) + (x A^T) B^T * scaling`` with ``lora_A``
    (r, in) and ``lora_B`` (out, r), the reference's torch keys (the JAX
    AdaptDense, adapters.py:56-81). r = 0 is a plain Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__(in_features, out_features, bias=bias)
        self.lora_r = int(lora_r)
        if self.lora_r > 0:
            self.scaling = float(lora_alpha) / self.lora_r
            self.lora_A = nn.Parameter(torch.zeros(self.lora_r, in_features))
            self.lora_B = nn.Parameter(torch.zeros(out_features, self.lora_r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_r == 0:
            return y
        return y + F.linear(F.linear(x, self.lora_A), self.lora_B) * self.scaling


class AdaptConv(nn.Conv2d):
    """nn.Conv2d with an optional LoRA term in the JAX package's form
    (adapters.py:84-121): ``lora_A`` a (r, Cin, kh, kw) conv with the base's
    strides and padding, then ``lora_B`` a 1 x 1 conv from r to the outputs,
    scaled by lora_alpha / r (not the reference's packed form). Its keys are
    ``lora_A.weight`` and ``lora_B.weight``, the ones the JAX loader reads
    (train/checkpoint.py:267-269)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__(in_channels, out_channels, kernel_size=kernel_size, stride=stride,
                         padding=padding)
        self.lora_r = int(lora_r)
        if self.lora_r > 0:
            self.scaling = float(lora_alpha) / self.lora_r
            self.lora_A = nn.Conv2d(in_channels, self.lora_r, kernel_size=kernel_size,
                                    stride=stride, padding=padding, bias=False)
            self.lora_B = nn.Conv2d(self.lora_r, out_channels, kernel_size=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_r == 0:
            return y
        return y + self.lora_B(self.lora_A(x)) * self.scaling


def has_lora(module: nn.Module) -> bool:
    """Whether ``module`` holds a LoRA layer."""
    return any(getattr(m, "lora_r", 0) > 0 for m in module.modules())


def kernel_refusal(module: nn.Module, adapters: bool = True) -> Optional[str]:
    """Why the kernels cannot run ``module`` (a Swin block, a patch embed,
    an encoder or a whole model), or None where they can. This is the port's
    one rule of which adapt settings reach the kernels: none of them has a
    LoRA term, and K4/K5 take constant-scalar gelu adapters without the
    second MLP bottleneck ``adapter_ds``. ``adapters=False`` asks for a route
    that takes no adapter at all (K11's stages, the EINV2 forward). What the
    kernels refuse trains and evaluates on the eager modules."""
    for m in module.modules():
        if getattr(m, "lora_r", 0) > 0:
            return "LoRA (the kernels have no LoRA term)"
        if getattr(m, "adapter_ds", None) is not None:
            return "new_adapter (K4/K5 have no second MLP bottleneck)"
        if isinstance(m, Adapter) and not adapters:
            return "adapters (K11's stages and the EINV2 forward take none)"
        if isinstance(m, Adapter) and (m.scale is None or m.act_layer != "gelu"):
            return ("an adapter with a learnable scale or a non-gelu activation (K4/K5 take "
                    "constant-scalar gelu adapters)")
    return None


def check_kernels(module: nn.Module, adapters: bool = True) -> None:
    """Raise NotImplementedError where ``kernel_refusal`` refuses ``module``."""
    why = kernel_refusal(module, adapters)
    if why is not None:
        raise NotImplementedError(f"{why}: such a model runs on the eager modules")


class AdaptConfig:
    """Static view over cfg.adapt (reference configs/adapt/*.yaml)."""

    def __init__(self, cfg_adapt: Optional[dict]):
        cfg_adapt = dict(cfg_adapt or {})
        self.method = str(cfg_adapt.get("method", "none") or "none")
        self.adapt_kwargs = dict(cfg_adapt.get("adapt_kwargs", {}) or {})
        self.linear_kwargs = dict(cfg_adapt.get("linear_kwargs", {}) or {})
        self.conv_kwargs = dict(cfg_adapt.get("conv_kwargs", {}) or {})

    @property
    def lora(self) -> bool:
        return "lora" in self.method

    @property
    def use_adapter(self) -> bool:
        return "adapter" in self.method and self.adapt_kwargs.get("type") == "adapter"

    def position(self) -> str:
        return "".join(map(str, self.adapt_kwargs.get("position", []) or []))

    @property
    def mlp_adapter(self) -> bool:
        return self.use_adapter and "MlpAdapter" in self.position()

    @property
    def spatial_adapter(self) -> bool:
        return self.use_adapter and "SpatialAdapter" in self.position()

    @property
    def new_adapter(self) -> dict:
        """The optional second parallel MLP bottleneck ``adapter_ds``
        (reference model_utilities.py:153-157); no shipped config sets it."""
        return dict(self.adapt_kwargs.get("new_adapter", {}) or {})

    def adapter_args(self) -> dict:
        """Keyword arguments of ``Adapter`` (reference defaults: mlp_ratio
        0.25, the learnable scalar, gelu); a constant scalar as the JAX
        Adapter takes it, ``float(value)`` (a bool as 1.0 or 0.0; None
        raises TypeError in both)."""
        kw = self.adapt_kwargs
        scalar = kw.get("adapter_scalar", LEARNABLE)
        return {"mlp_ratio": float(kw.get("mlp_ratio", 0.25)),
                "adapter_scalar": scalar if scalar == LEARNABLE else float(scalar),
                "act_layer": kw.get("act_layer", "gelu")}

    def ds_adapter_args(self) -> dict:
        """Keyword arguments of the ``new_adapter`` bottleneck (reference
        Adapter defaults, model_utilities_adapt.py:8-9: mlp_ratio 0.25,
        gelu, the constant scalar 1)."""
        kw = self.new_adapter
        scalar = kw.get("adapter_scalar", 1)
        return {"mlp_ratio": float(kw.get("mlp_ratio", 0.25)),
                "adapter_scalar": scalar if scalar == LEARNABLE else float(scalar),
                "act_layer": kw.get("act_layer", "gelu")}

    def lora_linear_args(self) -> dict:
        """``AdaptDense``'s LoRA rank and alpha (r 0 without LoRA)."""
        return self._lora_args(self.linear_kwargs)

    def lora_conv_args(self) -> dict:
        """``AdaptConv``'s LoRA rank and alpha (r 0 without LoRA)."""
        return self._lora_args(self.conv_kwargs)

    def _lora_args(self, kw: dict) -> dict:
        if not self.lora:
            return {"lora_r": 0}
        return {"lora_r": int(kw.get("r", 0)), "lora_alpha": float(kw.get("lora_alpha", 1.0))}


NO_ADAPT = AdaptConfig(None)
