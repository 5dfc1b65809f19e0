"""Small sizes of every cell, for runs on the CPU (the kernels' plain
versions) in the tests: the configuration's and the traffic's numbers
that change, the rest as the data files give them."""

SIZES = {
    "tokamak.rollout_batch": {"traffic": {
        "orbits": 64, "steps": 20, "ic_batches": 2, "max_launches": 64,
        "check_rows": 8}},
    "tokamak_large.rollout": {
        "config": {"N": 64, "aux": {"points": 32, "sig2n": 1e-10}},
        "traffic": {"orbits": 8, "steps": 20, "ic_batches": 2,
                    "check_rows": 4, "max_requests": 256}},
    "tokamak_large.fit": {"config": {"N": 64, "fit": {
        "theta0": [0.5, 2.5, 2.0], "steps": 5, "lr": 0.05}}},
}
