"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet, SXM part,
dense rates without sparsity, at the full power limit (a frozen copy of
the port's ``bench.py`` table, with the memory bandwidth added).  Float32
is outside the tensor cores: every entry point turns TF32 off."""

PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12},
}
PEAK_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_flops(kind, dtype):
    """The card's dense peak for ``dtype`` ("bfloat16" / "float32"), or
    None for a card not in the table."""
    return PEAK_FLOPS.get(kind, {}).get(dtype)


def peak_bytes(kind):
    return PEAK_BYTES.get(kind)
