"""torch.cuda.max_memory_allocated over the run (reset before set-up, read
before the reference runs), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
