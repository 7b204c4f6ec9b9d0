"""The benchmark of the PyTorch/CUDA port ``qgs_tpu_torch``: one cell a
run, ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
