"""Data parallelism over processes (port of ``madm_tpu/parallel``):
``dist`` holds the process groups, the collectives, ZeRO-1 and the spawned
ranks."""
