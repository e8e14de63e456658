"""The plain reference at a tiny size: its pieces against PyTorch's own,
and its losses' gradients against finite differences (``gradcheck``)."""

import pytest
import torch

from portbench import plain
from portbench.configs import vae_nb

VAE = {"feature_size": 6, "hidden_sizes": [5, 4], "latent_size": 3,
       "learning_rate": 1e-4}


def test_negative_binomial_against_torch():
    g = torch.Generator().manual_seed(0)
    t = torch.poisson(torch.full((50,), 3.0), generator=g)
    p_raw, log_r_raw = torch.randn(2, 50, generator=g)
    ours = plain.negative_binomial_log_prob(t, p_raw, log_r_raw)
    theirs = torch.distributions.NegativeBinomial(
        total_count=torch.exp(log_r_raw),
        probs=torch.sigmoid(p_raw)).log_prob(t)
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_batch_norm_against_torch():
    x = torch.randn(40, 7, generator=torch.Generator().manual_seed(1))
    params = {"n.batch_norm.0.beta": torch.linspace(-1, 1, 7)}
    state = {"n.batch_norm.0.mean": torch.zeros(7),
             "n.batch_norm.0.var": torch.ones(7)}
    new_state = {}
    ours = plain.batch_norm(params, state, new_state, "n", "n", 0, x,
                            training=True)
    theirs = torch.nn.functional.batch_norm(
        x, None, None, bias=params["n.batch_norm.0.beta"], training=True,
        eps=plain.BN_EPS)
    assert torch.allclose(ours, theirs, atol=1e-5)
    assert torch.allclose(new_state["n.batch_norm.0.mean"],
                          (1 - plain.BN_DECAY) * x.mean(0))


def test_clip_adam_against_torch_adam():
    g = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(5, 4, generator=g)}
    theirs = params["w"].clone().requires_grad_(True)
    adam = torch.optim.Adam([theirs], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    mu = {"w": torch.zeros(5, 4)}
    nu = {"w": torch.zeros(5, 4)}
    for count in range(1, 4):
        grad = 3 * torch.randn(5, 4, generator=g)
        plain.clip_adam_(params, {"w": grad}, mu, nu, count, 1e-3)
        theirs.grad = torch.clamp(grad, -1, 1)
        adam.step()
    assert torch.allclose(params["w"], theirs.detach(), atol=1e-6)


@pytest.mark.parametrize("spec", [VAE, {**VAE, "hidden_sizes": [5],
                                         "latent_size": 2}],
                         ids=["two_layers", "one_layer"])
def test_loss_gradients(spec):
    model = vae_nb
    params, state = model.init(spec, 2**31 + 3)
    names = sorted(params)
    g = torch.Generator().manual_seed(4)
    x = torch.poisson(torch.full((7, spec["feature_size"]), 2.0),
                      generator=g).double()
    noise = torch.randn(model.noise_shape(spec, 7), generator=g).double()
    state = {k: v.double() for k, v in state.items()}

    def loss(*leaves):
        values = dict(zip(names, leaves))
        return model.loss(spec, values, state, x, noise)[0]

    leaves = tuple(params[k].double().requires_grad_(True) for k in names)
    assert torch.autograd.gradcheck(loss, leaves, eps=1e-6, atol=1e-5)
