"""Share (%) of the profiled batch in which no operation ran on the device:
1 - union of device operation intervals / the stretch's wall time."""


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub.device_ops:
        return None
    return 100.0 * (1.0 - obs.sub.busy_s() / obs.sub.window_s)
