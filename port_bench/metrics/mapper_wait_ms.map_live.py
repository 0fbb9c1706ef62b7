"""The mapper loop's wait on its operation queue a train iteration (ms):
the program's `mapper.queue_wait` span around `queue.pop(timeout=0.01)` in
Mapper.run over the traced window's iterations, with keyframes arriving
(`mapper_wait_ms.map`'s reading, kept apart because that metric lists the
cells of the finished tracker)."""

from port_bench import program


def read(ctx):
    return program.span_ms(ctx, "mapper.queue_wait")
