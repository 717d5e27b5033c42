"""What the per-layer readers of the program's own spans share: a span's
device milliseconds a step, from the program's tracer
(``lattisense_torch/utils/observability.py``). The tracer records only
while a torch.profiler session records, so in a traced run its registry
holds the profiled window alone. A program without the tracer, or a window
without the span, gives None."""


def device_ms_per_step(name: str):
    """Span ``name``'s device ms summed over the recorded window, over the
    ``step`` roots the window recorded; None where there is none."""
    try:
        from lattisense_torch.utils import observability
        totals = observability.totals()
    except (ImportError, AttributeError):
        return None
    t = totals.get(name)
    if not t or t['device_ms'] is None or not t['steps']:
        return None
    return t['device_ms'] / t['steps']
