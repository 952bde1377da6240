"""The contract layer: every surface that declares a contract, held to
it (the JAX package's ``repro.analysis.contracts``).

Contracts are declared at the registries — ``KernelContract`` in
``repro_torch.kernels.dispatch``, ``AggregateContract`` on every
registered ``Strategy``, ``StepContract`` on ``ServingEngine`` — and
verified by running the real code over its declared cross-product
(kernels × backends × shape families, strategies × presets × fleets ×
straggler policies, serving step × arch families × adapter modes) on
``meta`` tensors, where nothing is allocated, or on the card.
Violations surface as :class:`Finding` objects through the same
baseline machinery as the AST rules:
``python -m repro_torch.analysis --contracts [--device cuda]``.
"""
_EXPORTS = ("CONTRACT_RULES", "run_contracts")


def __getattr__(name):
    # lazy: the checkers import the model code; keep the plain AST
    # analyzer (`python -m repro_torch.analysis` without --contracts) light
    if name in _EXPORTS:
        from repro_torch.analysis.contracts import driver
        return getattr(driver, name)
    raise AttributeError(name)
