"""Milliseconds of the round's furthest point sampling of its fakes
(``to_points``: points, FPS and gather), by the host clock ending in a
synchronise, averaged over the window's rounds."""


def read(ctx):
    spans = ctx.get("fps_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
