"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and a launch's least time.

The operation rates and terms are those ``chip_smoke.py`` bounds each
kernel by: bit operations at the non-tensor 32-bit rate, popcounts at
the card's ``__popc`` rate, ``mma.sync`` .b1 products at the int8
tensor rate, bytes at the HBM rate.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12           # HBM3
OPS_PER_S = 67e12                   # non-tensor 32-bit
INT8_TENSOR_OPS_PER_S = 1979e12     # dense int8 tensor cores
# __popc results a clock an SM, compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
POPC_PER_CLOCK_PER_SM = 16


def popc_per_s(device_index: int = 0) -> float:
    """The card's __popc rate: POPC_PER_CLOCK_PER_SM x its SMs x its
    maximum SM clock as nvidia-smi reports it."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", f"--id={device_index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6


def least_s(cost: dict, popcs_per_s: float) -> float:
    """A launch's least time in seconds: the larger of its bytes at the
    HBM rate and its operation terms at theirs."""
    return max(cost.get("bytes", 0) / HBM_BYTES_PER_S,
               cost.get("ops", 0) / OPS_PER_S,
               cost.get("popcs", 0) / popcs_per_s,
               cost.get("tensor_ops", 0) / INT8_TENSOR_OPS_PER_S)
