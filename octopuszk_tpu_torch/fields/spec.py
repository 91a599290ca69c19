"""Prime-field specifications: constants for the word arithmetic.

A ``FieldSpec`` packages what the Montgomery code needs about one prime
field: the modulus, the Montgomery constants for R = 2**256 (the radix is
the same whether a value is cut into eight 32-bit words, as on the card, or
into sixteen 16-bit limbs, as in the plain PyTorch CIOS and in the JAX
reference, so values convert by a repack), and 2-adicity data for the NTT
domains.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from octopuszk_tpu_torch.utils.bigint import int_to_words

R_BITS = 256            # Montgomery radix R = 2**256
HALF_BITS = 16          # the plain CIOS works on 16-bit halves of each word
HALF_MASK = (1 << HALF_BITS) - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Constants for one prime field (hashable)."""

    name: str
    p: int                       # modulus
    generator: int               # multiplicative generator of F_p^*
    two_adicity: int             # s with p - 1 = t * 2**s, t odd
    root_of_unity: int           # element of order 2**two_adicity

    def __post_init__(self):
        assert self.p % 2 == 1 and self.p < (1 << R_BITS)

    @functools.cached_property
    def r_mod_p(self) -> int:
        return (1 << R_BITS) % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return (1 << (2 * R_BITS)) % self.p

    @functools.cached_property
    def n0inv16(self) -> int:
        """-p^-1 mod 2**16 (per-limb constant of the plain 16-bit CIOS)."""
        return (-pow(self.p, -1, 1 << 16)) % (1 << 16)

    @functools.cached_property
    def n0inv32(self) -> int:
        """-p^-1 mod 2**32 (per-word constant of the CUDA CIOS)."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    @functools.cached_property
    def p_minus_2(self) -> int:
        return self.p - 2

    # ---- numpy constant tables (int32[8] word patterns) ----

    @functools.cached_property
    def p_words(self) -> np.ndarray:
        return int_to_words(self.p)

    @functools.cached_property
    def r2_words(self) -> np.ndarray:
        return int_to_words(self.r2_mod_p)

    @functools.cached_property
    def one_mont_words(self) -> np.ndarray:
        """1 in Montgomery form, i.e. R mod p."""
        return int_to_words(self.r_mod_p)

    def wide_fixup_words(self, k: int, out_mont: bool) -> np.ndarray:
        """Montgomery factor fixing up a from_wide reduction of k 16-bit
        REDC passes: after them a wide value X is X * 2**(-16k) mod p;
        mont_mul by this constant yields X mod p (raw) or X*R mod p."""
        e = HALF_BITS * k + R_BITS + (R_BITS if out_mont else 0)
        return int_to_words(pow(2, e, self.p))

    # ---- field ops on python ints (host oracle) ----

    def to_mont(self, x: int) -> int:
        return (x << R_BITS) % self.p

    def from_mont(self, a: int) -> int:
        return (a * pow(1 << R_BITS, -1, self.p)) % self.p

    def rou_of_order(self, order: int) -> int:
        """Root of unity of the given power-of-two order."""
        assert order & (order - 1) == 0
        log = order.bit_length() - 1
        assert log <= self.two_adicity, "domain too large for field 2-adicity"
        return pow(self.root_of_unity, 1 << (self.two_adicity - log), self.p)

    def __hash__(self):
        return hash((self.name, self.p))


# BN254 ("BN254a" in DIZK / alt_bn128)
FR = FieldSpec(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
    root_of_unity=19103219067921713944291392827692070036145651957329286315305642004821462161904,
)

FQ = FieldSpec(
    name="bn254_fq",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
    two_adicity=1,
    root_of_unity=21888242871839275222246405745257275088696311157297823662689037894645226208582,
)


# BN254b, the reference's second curve (its `zksnark-large` app): both
# moduli 254-bit, two-adicity 50
FR_B = FieldSpec(
    name="bn254b_fr",
    p=17855808334804902850260923831770255773646114952324966112694569107431857586177,
    generator=7,
    two_adicity=50,
    root_of_unity=17729182186811642101367803457606981491707192560180443271869306861118266354030,
)

FQ_B = FieldSpec(
    name="bn254b_fq",
    p=17855808334804902850260923831770255773779740579862519338010824535856509878273,
    generator=5,
    two_adicity=50,
    root_of_unity=8794480323307618088839840625900989315206881983614277345799820743772850434426,
)


# The reference's test fields, which belong to no curve: they run the
# generic word kernels at other moduli.  SMALL is a 62-bit NTT prime, 29 *
# 2^57 + 1 (two-adicity 57); LARGE is the BLS12-381 scalar field, 255 bits
# (two-adicity 32), the widest modulus the kernels take (ops/kernels.py
# constants_header).
_SMALL_P = 4179340454199820289
_LARGE_P = 52435875175126190479447740508185965837690552500527637822603658699938581184513

SMALL = FieldSpec(
    name="small_fp",
    p=_SMALL_P,
    generator=3,
    two_adicity=57,
    root_of_unity=pow(3, 29, _SMALL_P),
)

LARGE = FieldSpec(
    name="large_fp",
    p=_LARGE_P,
    generator=7,
    two_adicity=32,
    root_of_unity=pow(7, (_LARGE_P - 1) >> 32, _LARGE_P),
)
