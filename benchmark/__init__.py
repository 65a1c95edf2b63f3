"""The benchmark of the PyTorch + CUDA port (`raytracing_gpu_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; `control.py` reads the
comparison's control and planted faults at a cell's own size.  The
frozen plain reference lives in `reference/`, the cells' data in
`configs/`, `traffic/` and `limits/`, one module a kind of request in
`kinds/`, and one reader a metric in `metrics/`.
"""
