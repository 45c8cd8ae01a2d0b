"""The slab gather-conv kernel's (B1, csrc/slab_conv.cu) share of its
roofline, in %: over the traced clouds, the sum of each 27-column conv's
least time (the larger of its operations over the bf16 peak and its bytes
over the HBM peak, stbench/flops.py) over the kernel's device time (its
launches' two kernels in the profile). Nothing where it did not run."""


def read(rec):
    if not rec.trace or rec.precision != "bfloat16":
        return None
    spent = sum(s for name, s in rec.trace["kernel_s"].items()
                if "slab_conv_kernel" in name or "slab_weight_fragments" in name)
    if spent <= 0:
        return None
    bound = sum(c.bound_s(rec.precision) for k in rec.traced for c in rec.inventory(k)
                if c.k3 == 27)
    return 100.0 * bound / spent
