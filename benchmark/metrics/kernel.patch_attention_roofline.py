"""Patch attention's share of its roofline, in %: over the traced clouds,
the sum of each patch's least time (the larger of its operations, 4 x
queries x keys x channels, over the precision's peak and its Q, K, V and O
bytes over the HBM peak: the architecture's `Attention` items, arch/ptv3.py)
over the device time of the attention kernels that
`scaled_dot_product_attention` launched (ATTENTION_KERNELS). Nothing where
the inventory has no attention or no such kernel ran."""

# name fragments of the kernels scaled_dot_product_attention launches on an
# H100: FlashAttention-2 (no mask), the memory-efficient kernel (a mask) and
# cuDNN's (`cudnn_generated_fort_native_sdpa_...`)
ATTENTION_KERNELS = ("flash_fwd", "fmha_cutlass", "native_sdpa")


def attention_s(trace):
    return sum(s for name, s in trace["kernel_s"].items()
               if any(f in name for f in ATTENTION_KERNELS))


def read(rec):
    if not rec.trace:
        return None
    spent = attention_s(rec.trace)
    bound = sum(o.bound_s(rec.precision) for k in rec.traced for o in rec.inventory(k)
                if getattr(o, "kind", None) == "attention")
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
