"""Share (%) of the profiled steps in which no operation ran on the device:
1 - union of device operation intervals / the stretch's wall time, the
mean over ranks."""


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub.device_ops:
        return None
    busy = getattr(obs, "busy_s_ranks", None) or [obs.sub.busy_s()]
    window = getattr(obs, "window_s_ranks", None) or [obs.sub.window_s]
    return 100.0 * (1.0 - sum(b / w for b, w in zip(busy, window)) / len(busy))
