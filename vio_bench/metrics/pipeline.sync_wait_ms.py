"""Host ms a frame spent waiting on the card: the Timing entries
`sync.<tag>` (okvis_tpu_torch.utils.syncstats.sync: each blocking
device-to-host fetch, host upload and eigh check, in any thread), their
totals over the window's frames. Nothing where the program keeps no such
entry."""


def read(record):
    if not record or not record.get("frames"):
        return None
    waits = [v for k, v in record["stages_s"].items() if k.startswith("sync.")]
    return 1e3 * sum(waits) / record["frames"] if waits else None
