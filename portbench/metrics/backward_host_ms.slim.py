"""Host ms per SLIM train step in the program's `slim.backward` span: loss.backward() (SlimTrainer._loss_and_grads). Autograd launches the backward's kernels from its own thread, so no span of the main thread holds them: the metric is the host's wait for the backward. The mean over the span ring's last calls, one a window step: a window of ~95 steps leaves set-up's first step, which builds kernels, in a ring of 256."""
from portbench import program_spans


def read(record):
    trace = program_spans.tracer()
    st = trace.stats("slim.backward") if trace else None
    n = len(record.step_s)
    if not st or not st["ring_ms"] or n == 0:
        return None
    ring = st["ring_ms"][-n:]
    return sum(ring) / len(ring)
