"""The count likelihood's share of its roofline, in %: the least time its
work in the profiled epoch's training steps needs (the configuration's
``likelihood_calls``, counted by ``roofline.likelihood_least_seconds``)
over the device time of the kernels that do it (the heads kernels, their
products, the forward's row-sum reduction and the float32 split's pack)."""

import re

from portbench import roofline

MOVES = "train_cells_per_s"

LIKELIHOOD_KERNELS = re.compile(
    r"\b(tc_heads_kernel|tc_product_kernel|split_pack_kernel|"
    r"cat_tc_forward_kernel|cat_tc_gradient_kernel|grouped_tc_heads_kernel|"
    r"cp_tc_forward_kernel|cp_tc_gradient_kernel|cp_merge_kernel)\b"
    r"|^(void )?(scvae::(\(anonymous namespace\)::)?)?reduce_kernel\b")


def read(run):
    if run.trace is None:
        return None
    seconds = sum(d for name, _, d in run.trace.kernels
                  if LIKELIHOOD_KERNELS.search(name))
    if not seconds:
        return None
    least = sum(roofline.likelihood_least_seconds(**call) for call in
                run.reference.likelihood_calls(run.spec, run.batch))
    return least * run.steps_per_epoch / seconds * 100.0
