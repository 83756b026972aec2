"""The card's peaks that the rooflines divide by.

Published figures of the NVIDIA H100 SXM (80 GB HBM3): NVIDIA's H100
datasheet (dense rates, half the "with sparsity" ones) and the CUDA C++
Programming Guide's arithmetic-instruction throughput table for compute
capability 9.0, at the boost clock of 1.98 GHz over 132 SMs. They assume
the card's full 700 W; every result line carries the card's name, and
``PERF.md`` its power limit.

``b1`` has no published rate. 10.1e15 operations a second (an and and a
popcount-accumulate counted as two per bit pair) is the rate of
``mma.sync.m16n8k256.b1`` alone at 8 and 16 warps an SM, as the port's
probe ``slam_loop_closing_tpu_torch/csrc/probes/probe_hamming_forms.py``
measured it on an NVIDIA H100 80GB HBM3 at 700 W; the same figure is
``chip_smoke.py``'s ``PEAK_OPS_PER_S["b1"]``.
"""

SMS = 132
BOOST_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "b1": 10.1e15,
    # float32 add, multiply or FMA instructions: 128 a clock an SM
    "ffma": 128 * SMS * BOOST_HZ,
    # float32 min, max and compares on the min/max pipe: 64 a clock an SM
    "fmnmx": 64 * SMS * BOOST_HZ,
}


def least_seconds(nbytes: float, ops: dict) -> float:
    """The least time of work that moves ``nbytes`` through device memory
    (each input read once, each output written once) and issues
    ``ops[pipe]`` operations on each pipe, the pipes side by side."""
    t_ops = max((n / OPS_PER_S[k] for k, n in ops.items()), default=0.0)
    return max(nbytes / HBM_BYTES_PER_S, t_ops)
