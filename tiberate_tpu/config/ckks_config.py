"""CKKS parameter configuration and presets.

Behavioral equivalent of the reference ``tiberate/config/ckks_config.py``:
same prime layout ``[scale primes..., base message prime, special primes...]``,
same automatic level-budget sizing against the HE-standard security bound,
same presets (logN14/15/16/17 with 1/2/4/6 special primes).
"""

import math
import warnings
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from tiberate_tpu import errors
from tiberate_tpu.config.security_parameters import maximum_qbits
from tiberate_tpu.utils.primes import (
    generate_message_primes,
    generate_scale_primes,
)


class Preset(Enum):
    logN14 = "logN14"
    logN15 = "logN15"
    logN16 = "logN16"
    logN17 = "logN17"


_PRESET_CONFIGS = {
    Preset.logN14: {"logN": 14, "num_special_primes": 1},
    Preset.logN15: {"logN": 15, "num_special_primes": 2},
    Preset.logN16: {"logN": 16, "num_special_primes": 4},
    Preset.logN17: {"logN": 17, "num_special_primes": 6},
}


@dataclass
class CkksConfig:
    buffer_bit_length: int = 62
    scale_bits: int = 40
    logN: int = 15
    num_scales: int | None = None
    num_special_primes: int = 2
    sigma: float = 3.2
    uniform_ternary_secret: bool = True
    security_bits: int = 128
    quantum: str = "post_quantum"
    distribution: str = "uniform"
    force_secured: bool = True

    # Derived fields (filled in __post_init__).
    N: int = field(init=False, repr=False, default=0)
    q: list = field(init=False, repr=False, default_factory=list)

    @classmethod
    def parse(cls, src: "dict | Preset | str | CkksConfig", **kwargs):
        if isinstance(src, CkksConfig):
            return src
        if isinstance(src, str) and src.endswith("_30"):
            return cls.parse_30bit(src[: -len("_30")], **kwargs)
        if isinstance(src, str):
            src = Preset(src)
        preset_config = _PRESET_CONFIGS[src] if isinstance(src, Preset) else src
        assert isinstance(
            preset_config, dict
        ), "src must be a dictionary or a Preset enum."
        return cls(**preset_config, **kwargs)

    @classmethod
    def parse_30bit(cls, base: "str | Preset", **kwargs):
        """30-bit buffer-mode twin of a 62-bit preset (``"logN15_30"``):
        int32 residues / single-lane u32 kernels (reference
        ``ckks_config.py:93-96``), scale_bits=25, num_scales pinned to the
        62-bit preset's level budget for an equal-depth comparison.

        25-bit NTT-friendly primes at 2N spacing run out before the 62-bit
        depth at large rings (logN17: 16 exist), and deep chains can
        collide with the special band — the depth backs off until the
        chain fits instead of raising :class:`errors.NotEnoughPrimes`.
        """
        base_cfg = cls.parse(base)
        logN, depth = base_cfg.logN, base_cfg.num_scales
        avail = len(generate_scale_primes()[(25, 1 << logN)]) - 1
        depth = min(depth, avail)
        opts = dict(logN=logN, buffer_bit_length=30, scale_bits=25,
                    num_special_primes=2)
        opts.update(kwargs)
        while True:
            try:
                return cls(num_scales=depth, **opts)
            except errors.NotEnoughPrimes:
                depth -= 1
                if depth < 2:
                    raise

    def __post_init__(self):
        self.N = 2**self.logN
        self.int_scale = 2**self.scale_bits
        self.scale = np.float64(self.int_scale)

        # Message prime bit-length is W-2 (reference ckks_config.py:85).
        self.message_bits = self.buffer_bit_length - 2

        self.secret_key_sampling_method = (
            "uniform ternary" if self.uniform_ternary_secret else "sparse ternary"
        )

        # numpy dtype of device buffers: 62-bit mode stores residues as
        # 64-bit words (31-bit-halved Montgomery arithmetic); the 30-bit
        # mode uses int32 storage like the reference.
        self.numpy_dtype = {30: np.int32, 62: np.int64}[self.buffer_bit_length]

        try:
            message_special_primes = generate_message_primes()[
                self.message_bits
            ][self.N]
        except KeyError:
            raise errors.NotFoundMessageSpecialPrimes(
                message_bit=self.message_bits, N=self.N
            ) from None

        try:
            scale_primes = generate_scale_primes()[(self.scale_bits, self.N)]
        except KeyError:
            raise errors.NotFoundScalePrimes(
                scale_bits=self.scale_bits, N=self.N
            ) from None

        # Prime layout: rescaling drops primes from the front, key switching
        # from the back: [scale primes, base message prime, special primes].
        self.max_qbits = int(
            maximum_qbits(
                self.N, self.security_bits, self.quantum, self.distribution
            )
        )
        base_special_primes = message_special_primes[
            : 1 + self.num_special_primes
        ]

        try:
            num_scales = self.num_scales
            if num_scales is None:
                base_special_bits = sum(
                    math.log2(p) for p in base_special_primes
                )
                available_bits = self.max_qbits - base_special_bits
                num_scales = 0
                available_bits -= math.log2(scale_primes[num_scales])
                while available_bits > 0:
                    num_scales += 1
                    available_bits -= math.log2(scale_primes[num_scales])

            if len(scale_primes) < num_scales:
                # a slice would SILENTLY truncate the chain and blow up
                # much later as an IndexError in part construction (e.g.
                # logN17 at scale_bits=25: too few NTT-friendly 25-bit
                # primes at 2N spacing for the preset's depth)
                raise IndexError
            if set(scale_primes[:num_scales]) & set(base_special_primes):
                # deep 30-bit chains drift toward the message band and
                # can COLLIDE with a base/special prime (observed:
                # logN17 scale_bits=25 depth 15 repeats 260571137);
                # a repeated modulus breaks CRT — the chain is invalid
                raise IndexError
            self.num_scales = num_scales
            self.q = list(scale_primes[:num_scales]) + list(
                base_special_primes
            )
        except IndexError:
            raise errors.NotEnoughPrimes(
                scale_bits=self.scale_bits, N=self.N
            ) from None

        self.total_qbits = math.ceil(sum(math.log2(qi) for qi in self.q))
        if self.total_qbits > self.max_qbits:
            if self.force_secured:
                raise errors.ViolatedAllowedQbits(
                    scale_bits=self.scale_bits,
                    N=self.N,
                    num_scales=self.num_scales,
                    max_qbits=self.max_qbits,
                    total_qbits=self.total_qbits,
                )
            warnings.warn(
                f"Maximum allowed qbits are violated: "
                f"max_qbits={self.max_qbits:4d} and the "
                f"requested total is {self.total_qbits:4d}.",
                stacklevel=2,
            )

    @property
    def num_ordinary_primes(self) -> int:
        return self.num_scales + 1

    def __repr__(self):
        return (
            f"{self.buffer_bit_length}_{self.scale_bits}_{self.logN}_"
            f"{self.num_scales}_{self.num_special_primes}_{self.security_bits}_"
            f"{self.quantum}_{self.distribution}"
        )

    def __str__(self):
        return (
            f"CkksConfig(buffer_bit_length={self.buffer_bit_length}, "
            f"scale_bits={self.scale_bits}, logN={self.logN}, "
            f"num_scales={self.num_scales}, "
            f"num_special_primes={self.num_special_primes}, "
            f"sigma={self.sigma}, "
            f"uniform_ternary_secret={self.uniform_ternary_secret}, "
            f"security_bits={self.security_bits}, quantum='{self.quantum}', "
            f"distribution='{self.distribution}', "
            f"force_secured={self.force_secured})"
        )
