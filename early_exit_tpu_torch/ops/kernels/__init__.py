"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in a plain int (`launches`).
"""

KERNEL_SOURCES = ("conformer_block", "head_argmax", "attention")

# registers the `eet::` ops; the wrapper modules call them
from early_exit_tpu_torch.ops.kernels import library  # noqa: E402,F401


def launch_counts() -> dict:
    """Every wrapper's launch counter, by name (the block's per entry)."""
    from early_exit_tpu_torch.ops.kernels import attention, conformer_block, head_argmax
    return {**{"conformer_block_" + e: n
               for e, n in conformer_block.conformer_block.entry_launches.items()},
            "conformer_block_ablate": conformer_block.conformer_block_ablate.launches,
            "head_argmax": head_argmax.head_argmax.launches,
            "attention": attention.fused_attention.launches}
