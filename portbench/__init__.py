"""The benchmark of spcl_torch on one H100: see PERF.md and BENCHMARK.json.

`run.py` runs one cell once. Everything that belongs to one configuration,
traffic mix or metric sits in a file of its own, found by name:
`configs/<config>.json`, `traffic/<traffic>.json`, `limits/<workload>.json`,
`metrics/<metric>.py`, `drivers/<driver>.py`, `counts/<counts>.py` and
`reference/<reference>.py`.
"""
