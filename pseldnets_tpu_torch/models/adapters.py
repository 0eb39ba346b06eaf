"""AdapterBit bottleneck adapters in PyTorch, the counterpart of the JAX
package's models/adapters.py (``Adapter`` :30-53, ``AdaptConfig`` :124-200).

Parity target: reference src/models/components/model_utilities_adapt.py:7-42.
An ``Adapter`` is a bottleneck MLP: fc1 (C -> C * mlp_ratio) -> exact erf
GELU -> fc2 (-> C), times a constant scalar. It sits parallel to the Swin
block's MLP ("MlpAdapter", models/common.py::Mlp) and after the attention
projection ("SpatialAdapter", models/htsat.py::WindowAttention). Its fc2
starts at zero (flax ``kernel_init=zeros``), so a fresh adapter is an
identity residual.

Ported: constant-scalar GELU bottleneck adapters, the shipped AdapterBit
configuration (configs/adapt/adapter.yaml). Raising ``NotImplementedError``
at model build time, naming ROADMAP.md queue A step 6: LoRA (``AdaptDense`` /
``AdaptConv``), a learnable ``adapter_scalar``, ``new_adapter`` and any
``act_layer`` but gelu - no shipped configuration uses them.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def constant_scalar(value) -> Optional[float]:
    """``adapter_scalar`` as a float when it is a constant (a number, or a
    numeric string as a command-line override gives it), else None (the
    ``learnable_scalar`` keyword, a bool, anything else)."""
    if isinstance(value, bool):
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class Adapter(nn.Module):
    """Bottleneck adapter with a constant scalar: ``scale * fc2(gelu(fc1 x))``.
    Parameter names fc1/fc2 are the reference's torch keys."""

    def __init__(self, dim: int, mlp_ratio: float, adapter_scalar: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.scale = float(adapter_scalar)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        with torch.no_grad():  # zero-init up-projection (adapters.py:45-47)
            self.fc2.weight.zero_()
            self.fc2.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none")) * self.scale


class AdaptConfig:
    """Static view over cfg.adapt (reference configs/adapt/*.yaml). Raises
    ``NotImplementedError`` on the settings the port does not run yet."""

    def __init__(self, cfg_adapt: Optional[dict]):
        cfg_adapt = dict(cfg_adapt or {})
        self.method = str(cfg_adapt.get("method", "none") or "none")
        self.adapt_kwargs = dict(cfg_adapt.get("adapt_kwargs", {}) or {})
        if self.lora:
            self._not_ported(f"adapt.method={self.method!r} (LoRA AdaptDense/AdaptConv)")
        if self.mlp_adapter or self.spatial_adapter:
            if not self.kernels_support():
                kw = self.adapt_kwargs
                self._not_ported(
                    f"adapter_scalar={kw.get('adapter_scalar', 'learnable_scalar')!r}, "
                    f"act_layer={kw.get('act_layer', 'gelu')!r}, "
                    f"new_adapter={bool(self.new_adapter)}: only constant-scalar gelu "
                    "bottleneck adapters without new_adapter are")

    @staticmethod
    def _not_ported(what: str):
        raise NotImplementedError(f"{what} not ported yet (ROADMAP.md queue A step 6)")

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
        """The optional second parallel MLP bottleneck (reference
        model_utilities.py:153-157); no shipped config sets it."""
        return dict(self.adapt_kwargs.get("new_adapter", {}) or {})

    def kernels_support(self) -> bool:
        """True when every block's structure runs on the kernels: no LoRA,
        and any bottleneck adapter has a constant scalar (a number or a
        numeric string, not a bool), gelu and no ``new_adapter``."""
        if self.lora:
            return False
        if not (self.mlp_adapter or self.spatial_adapter):
            return True
        kw = self.adapt_kwargs
        return (constant_scalar(kw.get("adapter_scalar", "learnable_scalar")) is not None
                and str(kw.get("act_layer", "gelu")).lower() == "gelu"
                and not self.new_adapter)

    def adapter_args(self) -> dict:
        """Keyword arguments of ``Adapter`` (reference defaults: mlp_ratio
        0.25)."""
        kw = self.adapt_kwargs
        return {"mlp_ratio": float(kw.get("mlp_ratio", 0.25)),
                "adapter_scalar": constant_scalar(kw.get("adapter_scalar", "learnable_scalar"))}


NO_ADAPT = AdaptConfig(None)
