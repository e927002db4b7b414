"""``backend="auto"`` (the NUTS default) on the port
(examples/auto_backend_nuts.py): the sampler picks its own tree engine.  The
warmup runs the dynamic tree (``"torch"``, the JAX package's ``"xla"``)
while tracking the realized tree depths; at the warmup→collection boundary
the JAX package's static↔dynamic crossover rule chooses the collection
backend — static when warmup trees saturate the cap or realize strongly
varied depths, the dynamic tree otherwise and always for caps > 6.
``.backend_selected`` / ``.depth_stats`` expose the decision after
``run()``."""

from general_mcmc_torch import NUTS, init_with_seed


def main(n_collect=256, n_warmup=128, device=None):
    def logp(x):
        return -0.5 * (x * x).sum(dim=-1)

    # A standard normal's adapted trees reach depth 2-3, so a cap of 3
    # stays saturated even after the step size converges -> auto resolves
    # the collection phase to the static window (7 unconditional
    # leapfrogs/transition, tree logic evaluated retrospectively).
    saturated = NUTS(
        logp, init_with_seed(128, 8, 0, device=device),
        target_accept_p=0.8, max_tree_depth=3, step_size=0.05,
        backend="auto", seed=0, device=device,
    )
    sample_a = saturated.run(n_collect, n_warmup)
    mean, std = saturated.depth_stats
    print(f"saturated cap-3 run:  backend_selected={saturated.backend_selected}"
          f"  (warmup depth mean {mean:.2f}, std {std:.2f})")

    # The default cap (10) always resolves to the dynamic tree — the
    # static window's 2^10 - 1 leapfrogs per transition would be absurd,
    # so auto skips tracking entirely and runs the exact dynamic path.
    roomy = NUTS(
        logp, init_with_seed(128, 8, 1, device=device),
        target_accept_p=0.8, backend="auto", seed=1, device=device,
    )
    sample_b = roomy.run(n_collect, n_warmup)
    print(f"default cap-10 run:   backend_selected={roomy.backend_selected}")

    assert saturated.backend_selected == "static"
    assert roomy.backend_selected == "torch"
    assert tuple(sample_a.shape) == tuple(sample_b.shape) == (128, n_collect, 8)
    return sample_a, sample_b


if __name__ == "__main__":
    main()
