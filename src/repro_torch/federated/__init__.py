from repro_torch.federated.aggregation import (  # noqa: F401
    aggregate,
    available_aggregations,
    fedavg,
    fedsa,
    flora_pad,
    register_aggregator,
)
from repro_torch.federated.client import make_local_train  # noqa: F401
