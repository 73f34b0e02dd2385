"""Host milliseconds of a ``ChunkRunner.run`` call (the K iterations'
draws, the rows' pinned upload, the draws' and learning rates' copies and
the graph's launch), timed on calls begun on an idle device, after the
traced segment: in the window each call waits inside for the previous
chunk's replay, which this leaves out.  The mean over those calls."""


def read(ctx):
    spans = ctx.get("chunk_host_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
