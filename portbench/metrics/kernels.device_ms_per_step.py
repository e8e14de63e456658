"""Device milliseconds a training step spends in the port's own kernels
(``ops/gather.py`` K1, ``ops/fused_likelihood.py`` K2/K3, from
``ops/csrc/``), over the profiled epoch's training steps; its evaluation
pass gathers with K1 too."""

import re

MOVES = "train_cells_per_s"

# The kernels of ``scvae_tpu_torch/ops/csrc`` by name; ``reduce_kernel``
# only outside PyTorch's namespace, which has one of that name.
PORT_KERNELS = re.compile(
    r"scvae::|\b(gather_vector_kernel|gather_element_kernel|"
    r"tc_heads_kernel|tc_product_kernel|split_pack_kernel|"
    r"cat_tc_forward_kernel|cat_tc_gradient_kernel|cp_tc_forward_kernel|"
    r"cp_tc_gradient_kernel|cp_merge_kernel|grouped_tc_heads_kernel)\b")
PORT_REDUCE = re.compile(r"^(void )?reduce_kernel\b")


def is_port_kernel(name: str) -> bool:
    return bool(PORT_KERNELS.search(name) or PORT_REDUCE.search(name))


def read(run):
    if run.trace is None:
        return None
    seconds = sum(d for name, _, d in run.trace.kernels
                  if is_port_kernel(name))
    if not seconds:
        return None
    return seconds / run.steps_per_epoch * 1e3
