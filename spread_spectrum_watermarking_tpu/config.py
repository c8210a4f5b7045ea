"""Configuration dataclasses for the watermarking pipelines.

These mirror the behavioral contract of the reference implementation's config
surface (reference: src/algorithm.rs:68-152 ``Insertion``/``Extraction``/
``OrderingMethod``/``WriteConfig``/``ReadConfig``) but are hashable frozen
dataclasses so they can be passed as static arguments to ``jax.jit`` and select
jittable code paths instead of boxed closures.

Defaults match the reference: Option2 insertion/extraction with alpha=0.1 and
Energy ordering (reference: src/algorithm.rs:104-112, 132-140).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class Method(str, enum.Enum):
    """Patent step-42 modulation equations (reference: src/algorithm.rs:68-77).

    - OPTION1: ``x' = x + alpha * w``       (alpha is absolute, not relative)
    - OPTION2: ``x' = x * (1 + alpha * w)`` (the paper's/reference's default)
    - OPTION3: ``x' = x * exp(alpha * w)``
    """

    OPTION1 = "option1"
    OPTION2 = "option2"
    OPTION3 = "option3"


class Ordering(str, enum.Enum):
    """Coefficient ranking metric (reference: src/algorithm.rs:143-152).

    - ENERGY: descending by ``v**2`` (DC coefficient excluded).
    - ENERGY_ORTHOGONAL: like ENERGY but each coefficient is first rescaled by
      the scipy-ortho normalization factor for its (row, col) position
      (reference: src/algorithm.rs:235-280).
    - LEGACY: descending by the *raw, signed* ortho-rescaled value -- the
      preserved 2013 bug (reference: src/algorithm.rs:223-232).
    """

    ENERGY = "energy"
    ENERGY_ORTHOGONAL = "energy-orthogonal"
    LEGACY = "legacy"


class Precision(str, enum.Enum):
    """Transform precision tier.

    HIGHEST   = IEEE f32 dots everywhere: the reference-exact parity tier.
    HIGH      = the fast path with its f32-operand dots (the first DCT pass
                and the read side's gather-dot) at ``lax.Precision.HIGH``,
                which an H100 runs as TF32.
    DEFAULT   = the fast path with every dot on bf16 operands (f32
                accumulation): the production tier.

    Both fast tiers rank on a plane whose second pass is a bf16 dot, and
    invert the sparse delta in bf16; ``tests/test_precision_gate.py`` and
    ``chip_smoke.py`` pin their detection to HIGHEST's.
    """

    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


#: Current fast-tier ranking generation. The fast (non-HIGHEST) tiers' rank
#: order is part of the stored watermark format (ops/ranking.py COMPATIBILITY
#: CONTRACT): version 1 selected on plain bf16 metric keys and gathered the
#: n coefficient values from the plane; version 2 (current) is gather-free --
#: the value estimate rides inside the ``approx_max_k`` key with the
#: coefficient's sign in the bf16 key's LSB, which permutes near-tie/boundary
#: selections relative to v1. Marks embedded under one version must be read
#: under the same version; utils/storage.py spells the pair as
#: "Default"/"High" (v1) vs "Default2"/"High2" (v2) so files self-describe.
RANK_VERSION = 2


@dataclasses.dataclass(frozen=True)
class InsertExtract:
    """Method + strength pair, serialized into the watermark JSON store.

    Mirrors the reference CLI's ``SerializableInsertExtract``
    (reference: examples/main.rs:62-71): alpha defaults to 0.1, method to
    Option2.
    """

    alpha: float = 0.1
    method: Method = Method.OPTION2


@dataclasses.dataclass(frozen=True)
class WriteConfig:
    """Embedding configuration (reference: src/algorithm.rs:99-112)."""

    insertion: InsertExtract = InsertExtract()
    ordering: Ordering = Ordering.ENERGY
    precision: Precision = Precision.HIGHEST
    # Optional custom insertion: callable (indices, original, mark) -> new
    # values, traced into the jitted pipeline. Replaces the reference's
    # ``Insertion::Custom`` boxed closure (src/algorithm.rs:76).
    custom_insert: Optional[Callable] = None
    # Optional custom ranking metric: callable (flat_indices, values) ->
    # metric, ranked descending with ties broken toward the lower flat index.
    # The vectorized equivalent of the reference's comparator-based
    # ``OrderingMethod::Custom`` (src/algorithm.rs:150-151): a comparator
    # cannot be data-parallel, a metric can. Overrides ``ordering`` when set.
    custom_ordering: Optional[Callable] = None
    # Fast-tier ranking generation (see RANK_VERSION). Only meaningful at the
    # non-HIGHEST tiers; set to 1 to read/write marks in the legacy
    # value-gather format.
    rank_version: int = RANK_VERSION

    def __hash__(self):
        return hash((self.insertion, self.ordering, self.precision,
                     self.rank_version,
                     id(self.custom_insert) if self.custom_insert else None,
                     id(self.custom_ordering) if self.custom_ordering else None))


@dataclasses.dataclass(frozen=True)
class ReadConfig:
    """Extraction configuration (reference: src/algorithm.rs:127-140)."""

    extraction: InsertExtract = InsertExtract()
    ordering: Ordering = Ordering.ENERGY
    precision: Precision = Precision.HIGHEST
    # Optional custom extraction: callable (indices, base, derived) -> mark.
    custom_extract: Optional[Callable] = None
    # Optional custom ranking metric; see WriteConfig.custom_ordering. The
    # read path must rank with the same metric the write path used
    # (reference: src/algorithm.rs:462-498 re-derives the ordering).
    custom_ordering: Optional[Callable] = None
    # Fast-tier ranking generation; must match the version the mark was
    # EMBEDDED with (the CLI restores it from the stored spelling).
    rank_version: int = RANK_VERSION

    def __hash__(self):
        return hash((self.extraction, self.ordering, self.precision,
                     self.rank_version,
                     id(self.custom_extract) if self.custom_extract else None,
                     id(self.custom_ordering) if self.custom_ordering else None))


def jax_precision(p: Precision):
    import jax

    return {
        Precision.DEFAULT: jax.lax.Precision.DEFAULT,
        Precision.HIGH: jax.lax.Precision.HIGH,
        Precision.HIGHEST: jax.lax.Precision.HIGHEST,
    }[p]
