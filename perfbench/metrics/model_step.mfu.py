"""The whole step's share of the card's bf16 peak over the traced slice, in
%: model FLOPs of the work served in the slice (2 x non-embedding
parameters per token, 4 dk H per visible (query, key) pair per layer, 2 d V
per sampled position; ``roofline.model_flops``), reckoned from the chunk and
decode-row lengths the benchmark observed, over the slice's seconds x 989
TFLOP/s."""
from perfbench import roofline as RL


def read(ctx):
    sl = ctx["slice"]
    if sl is None:
        return None
    if not (sl["work"].chunks or sl["work"].decode_keys):
        return None
    work = sl["work"].model_work()
    flops = RL.model_flops(ctx["dims"], work)
    return 100.0 * flops / (sl["seconds"] * RL.PEAK_BF16_FLOPS)
