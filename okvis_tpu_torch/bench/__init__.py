"""The port's measurement tools, one module per JAX-side tool and with its
name (bench.py, bench_scaling.py and scripts/*.py of the repo), each run as
``python -m okvis_tpu_torch.bench.<name>``:

- bench_pipeline: full-pipeline frames/s and ATE through ThreadedVio, with
  the captured per-frame programs replayed for their device time;
- bench_host: the same run's host bookkeeping stages per frame;
- bench: the headline line (the pipeline's wall frames/s, the BA window's
  optimize steps/s);
- accuracy_proxy: long synthetic scenarios through the whole pipeline,
  gated on their ATE, over five configurations;
- bench_posegraph, bench_deadline, bench_tiers, profile_ba, bench_detect,
  bench_big_window, bench_scaling, study_relpose: one layer each.

Every module runs on the card unless given ``--device cpu``, builds its
parameters in code (``--config PATH`` reads a YAML where a tool takes
one), keeps matmuls in full float32 (TF32 off) and writes only where its
caller says. Nothing runs at import.
"""
