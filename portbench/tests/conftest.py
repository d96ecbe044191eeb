"""The benchmark's own tests: CPU only, run with

    python -m pytest portbench/tests -q

They import the harness's modules from ``portbench/`` by their own names,
and drive whole runs in fresh interpreters through ``cpu_drive.py``."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH]
