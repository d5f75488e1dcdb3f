"""How many kernel records torch.profiler keeps as a process ages on the card.

Runs ``chip_smoke.py``'s phases 1 to 10b in one process, as its full run
does, and after each phase profiles five calls of the one-thread K5 kernel
(``linearize_kernel``, B=4096) with ``chip_smoke._device_ms``, its window
held open 0, 0.2, 1 and 3 s on either side of the calls
(``chip_smoke.PROFILE_PAD_S``), printing how many of the five kernels each
profile kept. Needs one CUDA card; from the repo's root:

    python3 chip_profile_probe.py
"""

from __future__ import annotations

import sys
import time

import torch

import chip_smoke as c

PADS = (0.0, 0.2, 1.0, 3.0)


def main() -> int:
    card, smi = c.phase_device()
    dev = torch.device("cuda")
    c.phase_build()
    args = c._k5_k7a_inputs(dev)["K5"][3](4096)
    call = c._k5_k7a_call("K5", "one-thread", args)
    call()
    t0 = time.perf_counter()
    kept = {pad: [] for pad in PADS}

    def probe(after):
        for pad in PADS:
            c.PROFILE_PAD_S, counts = pad, {}
            c._device_ms(lambda: [call() for _ in range(5)], counts)
            kept[pad].append(sum(n for k, n in counts.items()
                                 if "linearize_kernel" in k))
        print(f"[probe] {time.perf_counter() - t0:.1f} s, after phase "
              f"{after}: kernels kept of 5 with the window padded "
              + ", ".join(f"{p:g} s {kept[p][-1]}" for p in PADS), flush=True)

    probe("2")
    c.phase_permute(dev)
    probe("3")
    c.phase_k1(dev)
    probe("4")
    c.phase_k1_designs(dev)
    probe("4 designs")
    c.phase_k1_factor_designs(dev)
    probe("4 factor")
    st, info, prob, _, _ = c.phase_cold(dev, smi)
    probe("5")
    c.phase_warm(dev, st, prob)
    probe("6")
    c.phase_compaction(dev)
    probe("7")
    c.phase_plain_solve(dev)
    probe("8")
    c.phase_oracle(st, info, prob)
    probe("9")
    del st, info, prob
    torch.cuda.empty_cache()
    c.phase_sync_kernels(dev)
    probe("10")
    c.phase_k6_designs(dev)
    probe("10b")
    print("[probe] profiles that kept all 5 kernels: " + ", ".join(
        f"padded {p:g} s {sum(k == 5 for k in kept[p])} of {len(kept[p])}"
        for p in PADS) + f" on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
