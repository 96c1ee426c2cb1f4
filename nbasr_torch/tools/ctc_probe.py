"""The CTC recursion's step on one warp: what a state's chain costs, and how
many chains a warp can run side by side.

    python3 nbasr_torch/tools/ctc_probe.py

Builds ``nbasr_torch/csrc/ctc_probe.cu`` through ``_build`` (the kernels'
nvcc flags, into ``build/nbasr_torch/``), then times one warp running
n = 1, 2, 4 and 8 independent chains a lane for T = 2000 steps, each step
two log_adds one after the other and an add (a label state's step of the
alpha recursion, with ``ctc.cu``'s own ``log_add`` from
``ctc_log_add.cuh``), as the device time of 20 launches queued behind a
spin kernel (this checkout's ``chip_smoke.device_ms``).  Prints one JSON
line: the card, its top SM clock, and per n the µs a step, the µs a
chain-step and the cycles a step at that clock.  n = 1 is the latency of
one step's chain; the n at which a step starts to grow is how many states a
lane can hold before the warp's instruction rate, not the chain, sets the
step.  That bounds ``kWarpStates`` of ``nbasr_torch/csrc/ctc.cu``, the
states a warp of the warp path holds: 64, two a lane.
"""

import ctypes
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CHAINS = (1, 2, 4, 8)
STEPS = 2000


def max_sm_mhz():
    """The card's top SM clock in MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,nounits'],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.split()[0])


def main():
    if not torch.cuda.is_available():
        raise SystemExit('ctc_probe.py needs a CUDA device')
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from nbasr_torch.ops import _build
    probe = _build.function('ctc_probe', 'nbasr_ctc_probe',
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p])
    out = torch.empty(32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    mhz = max_sm_mhz()
    rows = {}
    for n in CHAINS:
        call = lambda: probe(n, STEPS, out.data_ptr(), stream)
        if call():
            raise RuntimeError(f'probe launch failed for n={n}')
        torch.cuda.synchronize()
        us = 1e3 * smoke.device_ms(call) / STEPS
        rows[n] = dict(us_per_step=us, us_per_chain_step=us / n,
                       cycles_per_step=us * mhz)
    print(json.dumps({'card': smoke.card_line(), 'max_sm_mhz': mhz,
                      'steps': STEPS, 'chains': rows}))


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    main()
