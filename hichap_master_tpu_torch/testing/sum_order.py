"""Sums in a fixed order on the card: ``ops.sparse.bin_sums`` against the
float ``index_add_`` it replaced, at about the 10 kb imputed table's size
(60 M float64 terms into 620,000 bins, uniform and skewed).  Prints, for
each, whether five runs give the same bits and the host-clock time of one
call (synchronized, mean of 10).

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/sum_order.py
"""

import subprocess
import time

import torch

from hichap_master_tpu_torch.ops.sparse import bin_sums


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    n, P = 620_000, 60_000_000
    idx = torch.randint(0, n, (P,), device=dev, generator=g)
    vals = torch.rand(P, dtype=torch.float64, device=dev, generator=g) * 3.7
    sidx, order = torch.sort(idx, stable=True)
    svals = vals[order]

    def ia():
        return torch.zeros(n, dtype=torch.float64,
                           device=dev).index_add_(0, idx, vals)

    def bs():
        return bin_sums(idx, vals, n)

    def bsp():
        return bin_sums(sidx, svals, n, presorted=True)

    for name, fn in (("index_add_", ia), ("bin_sums", bs),
                     ("bin_sums presorted", bsp)):
        outs = [fn() for _ in range(5)]
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        print(f"{name}: 5 runs bit-identical {same}, {ms:.3f} ms")
    ref = ia()
    print("max rel diff bin_sums vs index_add_",
          float(((bs() - ref).abs() / ref.abs().clamp_min(1e-300)).max()))
    # skewed bins: a few hold most of the terms
    idx2 = (torch.rand(P, device=dev, generator=g) ** 4 * n).long()
    a = [bin_sums(idx2, vals, n) for _ in range(3)]
    b = [torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, idx2, vals) for _ in range(3)]
    print("skewed: bin_sums identical", all(torch.equal(a[0], x) for x in a),
          "index_add_ identical", all(torch.equal(b[0], x) for x in b))


if __name__ == "__main__":
    main()
