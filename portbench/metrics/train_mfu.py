"""The window's share of the card's bf16 peak, in %: the matmul operations
that its epochs' training steps (forward and backward, no input gradient
for the layers that read the counts) and whole-set evaluations (forward)
need, counted from the shapes by the configuration's reference, over the
window's seconds and 989 TFLOP/s."""

from portbench import roofline

MOVES = "train_cells_per_s"


def read(run):
    model, spec = run.reference, run.spec
    epoch = (run.steps_per_epoch * model.train_flops(spec, run.batch)
             + model.eval_flops(spec, run.cells))
    flops = run.window_epochs * epoch
    return flops / run.window_seconds / roofline.BF16_FLOPS * 100.0
