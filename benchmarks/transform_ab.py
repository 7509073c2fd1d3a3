"""Time the fused cc_mult step with each NTT path, in one process.

    python benchmarks/transform_ab.py

At ``logN15`` and ``logN15_30``, batch 8: one engine per transform path
(``radix2``, ``int8_4step``), each step compiled once, then timed in the
order radix2, int8_4step, int8_4step, radix2, three loops each (every
loop ends in ``block_until_ready``).  Prints one JSON line per preset
with every loop's ms per ciphertext, the medians, compile seconds and
decrypt errors, and the device and card they were measured on.  The
faster path is the GPU default in ``tiberate_tpu/ops/transform.py``.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402

PRESETS = ("logN15", "logN15_30")
BATCH = 8
ITERS = 10


def main():
    from tiberate_tpu.ops.transform import TRANSFORMS
    from tiberate_tpu.utils.runtime import device_record, use_compile_cache

    use_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        sys.exit(f"transform_ab.py: needs a GPU, found {device['platform']}")
    for preset in PRESETS:
        steps, rec = {}, {"preset": preset, "batch": BATCH,
                          "device": device}
        for t in TRANSFORMS:
            call, check, compile_s = bench.prepare_step(
                bench.build_engine(preset, transform=t), BATCH)
            steps[t] = call
            rec[t] = {"compile_s": compile_s,
                      "decrypt_max_err": check(call()),
                      "loops_ms_per_ct": []}
        order = TRANSFORMS + TRANSFORMS[::-1]
        for t in order:
            _, loops = bench.time_loops(steps[t], ITERS)
            rec[t]["loops_ms_per_ct"] += [x / BATCH * 1e3 for x in loops]
        for t in TRANSFORMS:
            rec[t]["median_ms_per_ct"] = statistics.median(
                rec[t]["loops_ms_per_ct"])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
