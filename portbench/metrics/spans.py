"""The program's own spans (``rsq:<layer>.<phase>``, opened by
``robustsq_whisper_torch.utils.profiling.annotate``) read from a profiled
sub-window: its host operations and its device operations, each a (name,
start us, duration us) from one kineto trace, so on one clock. Every
function returns nothing to read (an empty list, or None) without a
finished sub-window or without the spans named, as on a program that opens
none."""

from portbench.harness import union


def named(obs, name):
    """The sub-window's spans ``name``, in start order."""
    sub = getattr(obs, "sub", None)
    if sub is None or sub.t1 is None:
        return []
    return sorted((h for h in sub.host_ops if h[0] == name), key=lambda h: h[1])


def nested_us(inner, outer):
    """Per span of ``outer``, the summed duration of the spans of ``inner``
    that lie inside it (both in start order, ``outer`` not overlapping)."""
    out, k = [], 0
    for _, a, d in outer:
        while k < len(inner) and inner[k][1] < a:
            k += 1
        total = 0.0
        while k < len(inner) and inner[k][1] + inner[k][2] <= a + d:
            total += inner[k][2]
            k += 1
        out.append(total)
    return out


def busy_us(obs, spans):
    """Per span, the device's busy time (the union of its operations)
    clipped to the span."""
    busy = union(obs.sub.device_ops)
    out, k = [], 0
    for _, a, d in spans:
        b = a + d
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        total, j = 0.0, k
        while j < len(busy) and busy[j][0] < b:
            total += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        out.append(total)
    return out


def ms_per_step(obs, name, step):
    """Summed duration (ms) of the spans ``name`` over the number of spans
    ``step``."""
    parts, steps = named(obs, name), named(obs, step)
    if not parts or not steps:
        return None
    return sum(d for _, _, d in parts) / 1e3 / len(steps)
