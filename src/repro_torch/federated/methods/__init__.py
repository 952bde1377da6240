"""Pluggable federated methods (Strategy API + registry).

Importing this package registers the seven built-in methods; external
code adds more with ``@register()`` on a ``Strategy`` subclass.
"""
from repro_torch.federated.methods.base import (  # noqa: F401
    AggregateContract,
    LocalSpec,
    StagedStrategy,
    Strategy,
    total_layers,
)
from repro_torch.federated.methods.registry import (  # noqa: F401
    available_methods,
    get_strategy,
    make_strategy,
    register,
    unregister,
)

# built-ins — import order is irrelevant; each module self-registers
from repro_torch.federated.methods import (  # noqa: E402,F401
    c2a,
    devft,
    dofit,
    fedit,
    fedsa,
    flora,
    progfed,
)
