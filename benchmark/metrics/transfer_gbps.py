"""transfer_gbps (GB/s; transfer: the transfer phase of engine/batches.py,
parallel/mesh.py `to_device`): the port's `transfer_bytes` counter, the
host arrays the batch loop copies to the card, over its `transfer` timer,
both summed over the window's analyses. None where the program counts no
`transfer_bytes`."""


def read(run):
    counted = [a for a in run.analyses if "transfer_bytes" in a.timers]
    seconds = sum(a.timers.get("transfer", 0.0) for a in counted)
    if seconds <= 0:
        return None
    return sum(a.timers["transfer_bytes"] for a in counted) / seconds / 1e9
