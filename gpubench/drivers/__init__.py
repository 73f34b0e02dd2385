"""One module per kind of cell: ``Run(spec, seed, device, rec)`` with
``setup()``, ``window(seconds, trace) -> end-to-end values``, ``traced()``,
``release()`` and ``check() -> [{"name", "value", "limit"}]``, and the
attributes ``attempted``, ``failed`` and ``context`` (what the per-layer
readers read)."""
