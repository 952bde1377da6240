"""Pluggable federated methods (Strategy API + registry).

Importing this package registers the ported built-in methods (devft,
fedit); external code adds more with ``@register()`` on a ``Strategy``
subclass. fedsa, flora, progfed, dofit and c2a are not ported yet
(ROADMAP.md).
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
from repro_torch.federated.methods import devft, fedit  # noqa: E402,F401
