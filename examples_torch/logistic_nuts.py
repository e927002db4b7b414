"""Hierarchical logistic regression with NUTS on the port
(examples/logistic_nuts.py): hundreds of batched chains over a
(p+2)-dimensional posterior.

The data come from the port's ``make_logistic_data`` (a seeded torch
generator), so its numbers are not the JAX example's; the recovery of
``beta_true`` is judged the same way.
"""

from general_mcmc_torch import NUTS, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.models.regression import HierarchicalLogistic, make_logistic_data


def main(n_obs=200, n_features=8, n_chains=256, n_collect=300, n_warmup=300, seed=0,
         device=None):
    X, y, beta_true = make_logistic_data(seed, n_obs, n_features, device=device)
    model = HierarchicalLogistic(X, y)
    sampler = NUTS(
        model,
        0.1 * init_with_seed(n_chains, model.dim, seed + 1, device=device),
        target_accept_p=0.8,
        mass_config=NUTSMassMatrixConfig(adaptation="diagonal", start_buffer=50,
                                         end_buffer=25, initial_window=25),
        seed=seed,
        device=device,
    )
    sample, stats = sampler.run_progress(n_collect, n_warmup, progress=False)
    print(stats)
    beta_hat = sample[:, :, 2:].reshape(-1, n_features).mean(dim=0).cpu().numpy()
    beta_true = beta_true.cpu().numpy()
    err = abs(beta_hat - beta_true)
    print(f"posterior-mean beta error: max={err.max():.3f} mean={err.mean():.3f}")
    return sample, beta_hat, beta_true


if __name__ == "__main__":
    main()
