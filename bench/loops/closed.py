"""The load ``closed`` (a mix's ``loop``): ``clients`` independent
closed-loop clients, each waiting for its answer before it sends its next
request (``benchlib.loop.closed_loop``).

A loop module exports ``run(system, draw, traffic, *, device, seconds,
max_flushes, sampler, annotate) -> benchlib.loop.LoopResult``."""
from benchlib.loop import closed_loop


def run(system, draw, traffic, **kw):
    return closed_loop(system, draw, clients=int(traffic["clients"]), **kw)
