"""Tracing / profiling helpers.

The JAX equivalent of the reference's compiler/profiling scaffolding
(``tiberate/jit/compiler.py`` — a torch.compile backend dumping FX graphs
when DEBUG_MODE=1; nvtx was a dependency but unused).  Here:

* :func:`profile` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace,
* :func:`annotate` — named trace regions (the nvtx.annotate analogue),
* :func:`enable_xla_dumps` — turn on XLA HLO dumps (the FX-SVG analogue),
* :func:`compiled_text` — fetch the optimized HLO of a jitted function.

All are zero-cost when unused.
"""

import contextlib
import os

import jax


@contextlib.contextmanager
def profile(logdir: str = "/tmp/tiberate_trace"):
    """Capture a device trace: ``with profile('/tmp/trace'): step()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a profile (nvtx.annotate analogue)."""
    return jax.profiler.TraceAnnotation(name)


def enable_xla_dumps(dump_dir: str = "/tmp/tiberate_xla_dump"):
    """Enable XLA HLO dumps for all subsequent compilations.

    Must run before the first compilation; returns the dump dir.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_dump_to" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_dump_to={dump_dir}".strip()
        )
    return dump_dir


def compiled_text(jitted_fn, *args, **kwargs) -> str:
    """Optimized HLO text of a jitted function at the given arg shapes."""
    return jitted_fn.lower(*args, **kwargs).compile().as_text()
