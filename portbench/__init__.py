"""The benchmark of ``pcr_tpu_torch`` (the PyTorch and CUDA port) on NVIDIA
cards: ``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  See ``README.md``."""
