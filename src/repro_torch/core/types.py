"""Shared configuration and state types of the sketch family.

``SketchConfig`` is a frozen (hashable) dataclass, derived exactly as the
JAX package derives it, so both packages draw the same hash family from the
same seed. States are NamedTuples of tensors; their dtypes follow the JAX
package (int8 registers, int32 histograms, float32 estimates).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point places its state on.

    A CUDA device is refused when no GPU is present: the port never moves
    to the CPU on its own — the caller asks for ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Configuration shared by QSketch / QSketch-Dyn and their keyed forms.

    Attributes:
      m: number of registers.
      b: register width in bits: r_min = -2^(b-1)+1, r_max = 2^(b-1)-1.
      seed: base salt; each hash role derives its own sub-salt from it.
    """

    m: int = 256
    b: int = 8
    seed: int = 0x5EED

    def __post_init__(self):
        if self.m < 3:
            raise ValueError("m >= 3 required (estimator variance needs m>=3)")
        if not (2 <= self.b <= 8):
            raise ValueError("register width b must be in [2, 8]")

    @property
    def r_min(self) -> int:
        """Smallest register value (and the empty-register init): -2^(b-1)+1."""
        return -(2 ** (self.b - 1)) + 1

    @property
    def r_max(self) -> int:
        """Largest register value (truncation ceiling): 2^(b-1)-1."""
        return 2 ** (self.b - 1) - 1

    @property
    def num_bins(self) -> int:
        """Histogram bins: one per representable register value."""
        return 2**self.b

    @property
    def top_bin(self) -> int:
        """Index of the r_max bin: r_max - r_min = 2^b - 2."""
        return self.r_max - self.r_min

    @property
    def salt_h(self) -> int:
        """Derived salt of the register-value hash role h_j."""
        return (self.seed * 0x9E3779B1 + 1) & 0xFFFFFFFF

    @property
    def salt_g(self) -> int:
        """Derived salt of the register-choice hash role g."""
        return (self.seed * 0x9E3779B1 + 2) & 0xFFFFFFFF

    @property
    def salt_perm(self) -> int:
        """Derived salt of the permutation keys (FastGM/FastExp schedules)."""
        return (self.seed * 0x9E3779B1 + 3) & 0xFFFFFFFF


class QSketchState(NamedTuple):
    """Registers of a QSketch."""

    regs: torch.Tensor  # int8[m], initialized to r_min


class SketchArrayState(NamedTuple):
    """K independent QSketches as one register matrix (core/sketch_array.py).

    Row k is bit-identical to a standalone ``QSketchState`` fed the
    sub-stream of elements whose key is k (same cfg, same hash family).
    """

    regs: torch.Tensor  # int8[K, m], initialized to r_min


class DynState(NamedTuple):
    """QSketch-Dyn state: registers + value histogram + running estimate."""

    regs: torch.Tensor  # int8[m]
    hist: torch.Tensor  # int32[2^b]; counts *touched* registers only
    chat: torch.Tensor  # float32 scalar, running weighted-cardinality estimate


class DynArrayState(NamedTuple):
    """K independent QSketch-Dyn sketches as one state (core/dyn_array.py)."""

    regs: torch.Tensor  # int8[K, m]
    hists: torch.Tensor  # int32[K, 2^b]; per-key counts of *touched* registers
    chats: torch.Tensor  # float32[K], running weighted-cardinality estimates


class WindowArrayState(NamedTuple):
    """Sliding-window DynArray: a ring of E epoch sub-states plus a cached
    full-ring union (core/window_array.py).

    Epoch e's (regs[e], hists[e], chats[e]) is a ``DynArrayState`` of the
    sub-stream folded while e was the current epoch; the union_* fields
    cache the all-epoch max-union with DynArray histogram and martingale
    maintenance on top. ``head`` is the ring slot of the current epoch,
    ``filled`` counts live epochs (<= E) and ``epoch_id`` is the monotone
    epoch clock (total rotations) fed to key-directory aging. The three
    scalars are int32 0-dim tensors on the state's device.
    """

    regs: torch.Tensor  # int8[E, K, m]
    hists: torch.Tensor  # int32[E, K, 2^b]; per-epoch touched-register hists
    chats: torch.Tensor  # float32[E, K], per-epoch running estimates
    union_regs: torch.Tensor  # int8[K, m] == max over the epoch axis
    union_hists: torch.Tensor  # int32[K, 2^b] touched-register hist of union
    union_chats: torch.Tensor  # float32[K] full-ring anytime estimates
    head: torch.Tensor  # int32 scalar, ring slot of the current epoch
    filled: torch.Tensor  # int32 scalar in [1, E], epochs live in the ring
    epoch_id: torch.Tensor  # int32 scalar, monotone epoch clock


class VirtualDynArrayState(NamedTuple):
    """Register-sharing virtual DynArray (core/virtual_dyn_array.py).

    Tail tenant t's logical register j lives at ``pool[hash(t, j) mod M]``:
    pool slots are written by many tenants, so a tail read subtracts the
    expected contribution of other tenants' traffic at query time (Wang et
    al., arXiv 1811.09126; DESIGN.md §8.9). Pinned hot tenants bypass the
    pool and keep dedicated dense ``DynArrayState`` rows.

    ``pool_hist`` is the FULL value histogram of the pool (bin ``v - r_min``
    counts slots at value v, untouched r_min slots included; bins sum to
    M). ``n_tail`` counts live tail element-occurrences folded in and
    ``w_tail`` their exact total weight, the noise scale of the
    cancellation. The scalars are 0-dim tensors on the state's device.
    """

    pool: torch.Tensor  # int8[M], shared tail register pool, init r_min
    pool_hist: torch.Tensor  # int32[2^b], full value histogram of the pool
    n_tail: torch.Tensor  # int32 scalar, live tail element-occurrences folded
    w_tail: torch.Tensor  # float32 scalar, exact total live tail weight folded
    hot: DynArrayState  # dedicated dense rows of the pinned hot tenants


class FloatSketchState(NamedTuple):
    """LM / FastGM / FastExpSketch state: float32 min-registers."""

    regs: torch.Tensor  # float32[m], initialized to float32 max
