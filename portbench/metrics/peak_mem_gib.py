"""``torch.cuda.max_memory_allocated()`` over the window's first batch,
in GiB: it caps the replicates a card takes per batch."""


def read(obs):
    return obs.batch_peak_bytes / 2**30 or None
