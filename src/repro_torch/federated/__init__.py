from repro_torch.federated.aggregation import (  # noqa: F401
    aggregate,
    available_aggregations,
    fedavg,
    fedsa,
    flora_pad,
    register_aggregator,
)
from repro_torch.federated.client import make_local_train  # noqa: F401
from repro_torch.federated.heterogeneity import (  # noqa: F401
    POLICIES,
    WEIGHTINGS,
    ClientPopulation,
    DeviceProfile,
    RoundPlan,
    aggregation_weights,
    available_fleets,
    make_population,
    plan_round,
    register_fleet,
)
from repro_torch.federated.methods import (  # noqa: F401
    LocalSpec,
    StagedStrategy,
    Strategy,
    available_methods,
    get_strategy,
    make_strategy,
    register,
)
from repro_torch.federated.simulator import (  # noqa: F401
    FedConfig,
    FederatedRunner,
    RoundLog,
)
