"""The reference's sampling noise is the program's, bit for bit: its own
copy of the row keys' hash and Gumbel draw against
``qaig_tpu_torch/infer/row_keys.py``, at the top word (the 24 bits all
ones, whose draw rounds to 1 in float32 and is held below it) and at
ordinary words."""

import torch

from benchmark import reference as ref

# row 52276 of seed 2**31 + 7 draws the top word at entry 479 of 513
TOP_SEED, TOP_ROW, TOP_ENTRY, VOCAB = 2 ** 31 + 7, 52276, 479, 513


def test_gumbel_matches_the_program_bit_for_bit():
    from qaig_tpu_torch.infer import row_keys
    keys = ref.fold_in(ref.key(TOP_SEED), torch.arange(
        TOP_ROW - 2, TOP_ROW + 2, dtype=torch.int64))
    assert torch.equal(keys, row_keys.fold_in(row_keys.key(TOP_SEED),
                                              torch.arange(TOP_ROW - 2,
                                                           TOP_ROW + 2)))
    assert int(ref._bits(keys, VOCAB)[2, TOP_ENTRY]) >> 8 == 0xFFFFFF
    ours, theirs = ref.gumbel(keys, VOCAB), row_keys.gumbel(keys, VOCAB)
    assert torch.equal(ours, theirs)
    assert float(ours[2, TOP_ENTRY]) == float(
        -torch.log(-torch.log(torch.tensor(1.0 - 2.0 ** -24))))
    assert bool(torch.isfinite(ours).all())
    assert torch.equal(ref.randint(keys, 512), row_keys.randint(keys, 512))
