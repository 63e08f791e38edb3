"""The benchmark of the PyTorch/CUDA port (``sesameai_tts_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See README.md."""
