"""Host syncs with the card (``torch.cuda.set_sync_debug_mode("warn")``)
over the profiled batch, per token-loop iteration."""


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_steps:
        return None
    return obs.sub.syncs / obs.sub_steps
