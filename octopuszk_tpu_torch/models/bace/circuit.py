"""Arithmetic circuit DAG for BACE (batch circuit evaluation).

Port of ``octopuszk_tpu/models/bace/circuit.py``.  A gate's value is an
``int32[8, B]`` Montgomery word tensor over B evaluation points at once
(or any batch shape after the word axis); products go through the
``mont_mul`` kernel, sums are plain tensor code.
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.utils.bigint import NUM_WORDS, int_to_words


class Gate:
    pass


class InputGate(Gate):
    def __init__(self, index: int):
        self.index = index

    def degree(self):
        return 1


class ConstantGate(Gate):
    def __init__(self, value: int):
        self.value = value

    def degree(self):
        return 0


class SumGate(Gate):
    def __init__(self, left: Gate, right: Gate):
        self.left, self.right = left, right

    def degree(self):
        return max(self.left.degree(), self.right.degree())


class ProductGate(Gate):
    def __init__(self, left: Gate, right: Gate):
        self.left, self.right = left, right

    def degree(self):
        return self.left.degree() + self.right.degree()


class Circuit:
    """A circuit with one output gate over ``input_size`` inputs."""

    def __init__(self, input_size: int, output: Gate):
        self.input_size = input_size
        self.output = output

    def total_degree(self) -> int:
        return max(1, self.output.degree())

    def compute(self, spec: FieldSpec, inputs):
        """inputs: int32[8, input_size, B...] Montgomery -> int32[8, B...].
        A gate used twice is evaluated once."""
        memo = {}
        batch = tuple(inputs.shape[2:])

        def ev(g: Gate):
            if id(g) in memo:
                return memo[id(g)]
            if isinstance(g, InputGate):
                v = inputs[:, g.index]
            elif isinstance(g, ConstantGate):
                w = torch.from_numpy(int_to_words(
                    spec.to_mont(g.value % spec.p))).to(inputs.device)
                v = w.reshape((NUM_WORDS,) + (1,) * len(batch)).expand(
                    (NUM_WORDS,) + batch)
            elif isinstance(g, SumGate):
                v = fp.add(spec, ev(g.left), ev(g.right))
            elif isinstance(g, ProductGate):
                v = fp.mont_mul(spec, ev(g.left), ev(g.right))
            else:
                raise TypeError(g)
            memo[id(g)] = v
            return v

        return ev(self.output)
