"""The plain reference: one module a model, named by its configuration.

A configuration file names its model's module under the top-level key
``"reference"``: ``"model"`` is ``reference/model.py``. :func:`module_for`
loads it from the ``reference/`` folder of the benchmark the file came
from, and raises for a name that folder does not hold.

A reference module holds, in plain PyTorch, importing nothing of the
program:

* ``stack_kinds(model)``: ``{stack: kind}`` of the layer stacks of the
  configuration's ``model`` section, in the order of the program's
  parameter tree;
* ``execution_order(model, sizes)``: ``[(stack, index), ...]``, the order
  in which a (sub)model of ``sizes`` layers a stack runs its layers;
* ``padded_vocab(model)``: the rows of the embedding and the logits;
* ``Model(model, params, beta=, quantize=)``: the f32 loss over the base
  weights ``params``, with ``.loss(sub, lora, batch, with_aux=)`` giving
  ``(loss + aux, loss)`` of the submodel ``sub`` ({stack: groups of base
  layers}) under the LoRA tree ``lora``; ``quantize`` rounds the frozen
  weight matrices to float8 (the lower-precision control);
* ``per_token(model, sizes, s, r)``: the (forward, backward) floating-point
  operations one token of a sequence of ``s`` takes through that submodel
  at LoRA rank ``r`` (``fedbench.flops`` counts the window's from it).

``model.py`` also holds what a new module need not write again:
``grads``, ``adamw``, ``fused_layer``, ``fp8_round``, ``rms_norm``,
``proj``, ``rope``, ``GEMM_LEAVES``, and a ``Model`` whose stacks,
order, position tables and blocks a subclass overrides.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[a-z][a-z0-9_]*")


def module_for(cfg_doc: dict, here: Optional[Path] = None) -> ModuleType:
    """The reference module ``cfg_doc["reference"]`` of the benchmark
    rooted at ``here`` (this package's benchmark by default)."""
    name = cfg_doc.get("reference")
    folder = HERE if here is None else Path(here).resolve() / "reference"
    path = folder / f"{name}.py" if isinstance(name, str) else None
    if path is None or not NAME.fullmatch(name) or not path.is_file():
        known = sorted(p.stem for p in folder.glob("*.py")
                       if NAME.fullmatch(p.stem))
        raise ValueError(
            f"configuration {cfg_doc.get('name')!r} names reference module "
            f"{name!r}; {folder} holds {known}")
    if folder == HERE:
        return importlib.import_module(f"{__name__}.{name}")
    from fedbench.bench import load_module

    return load_module(path, f"fedbench_reference_{name}")
