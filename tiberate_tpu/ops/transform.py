"""Which NTT implementation the engine runs, chosen from what it observes.

Two plain-JAX transforms compute the same residues:

* ``"radix2"`` — the reshape butterflies of :mod:`tiberate_tpu.ops.ntt`,
  one elementwise fusion per stage (the reference's one kernel launch per
  stage, ``csrc/cuda/ntt_cuda.cu:89-100``);
* ``"int8_4step"`` — the matmul-form 4-step of
  :mod:`tiberate_tpu.ops.mxu_ntt`, 7-bit limbs contracted by int8
  ``dot_general`` with int32 accumulation.

The choice depends only on the platform, the ring size and the lane width.
The GPU entry is the faster path in the batch-8 fused ``cc_mult`` step on
an H100 at ``logN15``, per lane (PERF.md, PR 1 findings); other ring sizes
follow it until a benchmark cell on each side says otherwise.
"""

TRANSFORMS = ("radix2", "int8_4step")

# Fused-step winner on the H100 per lane width (buffer_bit_length).
_GPU_DEFAULT = {62: "int8_4step", 30: "int8_4step"}


def choose_transform(platform: str, logN: int, buffer_bit_length: int,
                     requested: str | None = None) -> str:
    """The transform for an engine on ``platform`` ("cpu" or "gpu").

    ``requested`` (one of :data:`TRANSFORMS`) overrides the default; any
    other name, and any other platform, is an error.
    """
    if requested is not None:
        if requested not in TRANSFORMS:
            raise ValueError(
                f"unknown transform {requested!r}; expected one of "
                f"{TRANSFORMS}"
            )
        return requested
    if buffer_bit_length not in (30, 62):
        raise ValueError(f"buffer_bit_length={buffer_bit_length}")
    if platform == "cpu":
        return "radix2"
    if platform == "gpu":
        return _GPU_DEFAULT[buffer_bit_length]
    raise ValueError(f"no transform default for platform {platform!r}")
