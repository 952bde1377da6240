from repro_torch.data.synthetic import (  # noqa: F401
    FederatedData,
    client_rng,
    client_round_batches,
    make_federated_data,
)
