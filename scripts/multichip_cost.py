"""Multi-device cost model: measure the distributed path's only
collectives — the per-round replicated pmax verify scalar and the
finalize hash-prefix all_to_all — at realistic distinct counts on the
8-virtual-device CPU mesh, then project scaling efficiency onto NVLink
bandwidth.

The streaming phase is embarrassingly parallel (each device consumes
its own haloed span; DESIGN.md section 4): per-chip throughput is
unchanged by scale, so efficiency = T_stream / (T_stream + T_collect).
The collectives' VOLUME is what this script measures on the virtual
mesh (bytes exchanged is platform-independent); their TIME on real
hardware is about volume / link bandwidth (H100 NVLink: 450 GB/s each
way per card, NVIDIA data sheet; a projection, not a measurement).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/multichip_cost.py [--distinct-log2 20 22 24]
"""

import argparse
import time

import numpy as np

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--distinct-log2", type=int, nargs="+",
                    default=[20, 22, 24])
    ap.add_argument("--k", type=int, default=51)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from kaarme_tpu.parallel.sharded import make_mesh
    from kaarme_tpu.parallel.sharded_sort import (ShardedSortConfig,
                                                  ShardedSortCounter)
    from kaarme_tpu.utils import codec

    mesh = make_mesh(8, platform="cpu")
    ndev = 8
    k = args.k
    W = codec.words_per_kmer(k)

    print(f"mesh: {ndev} devices ({mesh.devices.ravel()[0].platform}); "
          f"k={k} W={W}")

    for dl in args.distinct_log2:
        n_distinct = 1 << dl
        per_dev = n_distinct // ndev
        cap = 1 << max(12, (per_dev * 2 - 1).bit_length())
        cfg = ShardedSortConfig(k=k, batch_windows=1 << 12, rows=1 << 6,
                                prefix_cap=cap, min_abundance=1)
        c = ShardedSortCounter(cfg, mesh)
        # synthesize per-device sorted distinct stores (uniform keys, so
        # the hash-prefix owners are uniform too)
        rng = np.random.default_rng(dl)
        cols = []
        for j in range(W):
            col = np.full((ndev, cap), 0xFFFFFFFF, np.uint32)
            col[:, :per_dev] = np.sort(
                rng.integers(0, 2**32, (ndev, per_dev), dtype=np.uint32),
                axis=1)
            cols.append(c._put_rows(col))
        cnt = np.zeros((ndev, cap), np.int32)
        cnt[:, :per_dev] = 1 + rng.integers(0, 30, (ndev, per_dev))
        cols.append(c._put_rows(cnt))
        c.prefix = tuple(cols)

        # finalize exchange: one all_to_all of (W+1) u32 columns over
        # the padded per-device capacity + per-shard compact
        t0 = time.perf_counter()
        c.finalize_exchange()
        jax.block_until_ready(c.prefix)
        t_ex = time.perf_counter() - t0

        vol_bytes = ndev * cap * (W + 1) * 4        # all_to_all payload
        # all_to_all moves (ndev-1)/ndev of the payload off each card
        link_bw = 450e9
        t_link = vol_bytes * (ndev - 1) / ndev / link_bw
        print(f"distinct=2^{dl}: exchange wall (8 virt CPU) {t_ex*1e3:.0f}ms"
              f"  payload {vol_bytes/1e6:.1f} MB"
              f"  projected NVLink time {t_link*1e3:.2f}ms", flush=True)

        # per-round verify scalar (replicated pmax): measure dispatch
        from jax.sharding import PartitionSpec as P
        f = jax.jit(jax.shard_map(lambda x: jax.lax.pmax(x[0, 0], "d")[None],
                              mesh=mesh, in_specs=P("d", None),
                              out_specs=P()))
        x = c.prefix[-1]
        f(x)
        t0 = time.perf_counter()
        reps = 20
        for _ in range(reps):
            v = f(x)
        jax.block_until_ready(v)
        t_pmax = (time.perf_counter() - t0) / reps
        print(f"  per-round pmax verify: {t_pmax*1e3:.2f}ms (virt CPU)",
              flush=True)

        # efficiency projection: headline stream rate per chip vs the
        # one-shot exchange amortized over the stream
        for rate_mps, windows in ((50e6, 1e9), (500e6, 1e9)):
            t_stream = windows / rate_mps
            eff = t_stream / (t_stream + t_link)
            print(f"  projected efficiency @ {rate_mps/1e6:.0f}M w/s/chip, "
                  f"1G windows/chip: {100*eff:.2f}%", flush=True)


if __name__ == "__main__":
    main()
