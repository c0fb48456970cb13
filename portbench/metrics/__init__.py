"""Per-layer metrics, one reader a file, found by the metric's name in
BENCHMARK.json, which alone holds the metric's unit, layer, `moves` and
source. read(ctx) returns the value, or None where its run holds nothing
to read (the harness then leaves it out).

ctx: "cell" (spec.Cell), "records" (each peer's record, with "trace":
busy intervals, ops by name, host spans; and "outer": each outer step's
times, Diloco.last_profile and ring bytes), "e2e" (the run's end-to-end
values), "busy_s", "window_s", "flops" (portbench.flops), "device_name".
"""
