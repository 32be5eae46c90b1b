"""Traffic of the node-sharded sparse SpMM (the halo part of
mpgcn_tpu/utils/flops.py; its step FLOPs model waits for the port's perf
module)."""

from __future__ import annotations


def halo_exchange_bytes(halo_cols: int, n_shards: int, F: int,
                        dtype_bytes: int = 4) -> int:
    """Cross-shard traffic of ONE halo exchange (parallel/halo.py): every
    shard receives ``halo_cols`` padded remote column slots of F features
    each. Replicated dense sharding moves N * F per shard per layer
    instead: the halo's share of that is halo_cols / N."""
    return n_shards * halo_cols * F * dtype_bytes


def quantized_halo_bytes(halo_cols: int, n_shards: int, F: int,
                         n_rounds: int) -> int:
    """Cross-shard traffic of ONE quantized halo exchange
    (``halo_spmm(quantized=True)``): every halo element travels as an int8
    code (1 byte), and each shard adds one f32 scale per ring round that
    carries traffic."""
    return n_shards * halo_cols * F * 1 + n_shards * n_rounds * 4
