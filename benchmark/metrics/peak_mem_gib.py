"""peak_mem_gib: torch.cuda.max_memory_allocated() over the run (reset
before set-up), GiB. Layer: device."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
