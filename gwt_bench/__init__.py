"""The benchmark of godot_whisper_tpu_torch on one NVIDIA H100.

``python3 -m gwt_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; see README.md.  Nothing here imports
JAX or the JAX package.
"""
