"""Device-to-host syncs per optimizer step, counted with
torch.cuda.set_sync_debug_mode('warn'): a count that repeats exactly."""


def read(rec):
    return rec.counters.get("host_syncs")
