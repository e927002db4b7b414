"""Tracking derived quantities with ``track`` on the port
(examples/regression_nc_track.py; core.rs:34-72 analog).

A non-centered hierarchical logistic model samples ``θ = [μ, log τ, z]``,
but the scientifically meaningful quantities are the coefficients
``β = μ + τ·z``.  ``sampler.track(...)`` installs a batched map from
positions to tracked quantities inside the sampling loop, so the collected
samples, streaming progress statistics and post-run R-hat/ESS all live on
the β scale.  The data come from the port's ``make_logistic_data`` (a
seeded torch generator, not the JAX example's numbers).
"""

from general_mcmc_torch import NUTS, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.models.regression import HierarchicalLogisticNC, make_logistic_data


def main(n_obs=200, n_features=8, n_chains=256, n_collect=300, n_warmup=300, seed=0,
         device=None):
    X, y, beta_true = make_logistic_data(seed, n_obs, n_features, device=device)
    model = HierarchicalLogisticNC(X, y)
    sampler = NUTS(
        model,
        0.1 * init_with_seed(n_chains, model.dim, seed + 1, device=device),
        target_accept_p=0.8,
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal", start_buffer=50,
                                         end_buffer=25, initial_window=25),
        seed=seed,
        device=device,
    ).track(model.beta)  # collected samples & diagnostics are β, not θ

    sample, stats = sampler.run_progress(n_collect, n_warmup, progress=False)
    assert tuple(sample.shape) == (n_chains, n_collect, n_features)  # β-dim, not θ-dim
    print("R-hat/ESS on the transformed (β) scale:")
    print(stats)
    beta_hat = sample.reshape(-1, n_features).mean(dim=0).cpu().numpy()
    beta_true = beta_true.cpu().numpy()
    err = abs(beta_hat - beta_true)
    print(f"posterior-mean beta error: max={err.max():.3f} mean={err.mean():.3f}")
    return sample, stats, beta_true


if __name__ == "__main__":
    main()
