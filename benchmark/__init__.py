"""The benchmark of plslam_tpu_torch: ``python3 -m benchmark.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the repository's root
(see ``run.py``)."""
