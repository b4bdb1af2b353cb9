"""Ballot mode: the per-election voting rule set and its packed encoding.

Role parity: reference spec/ballotmode.go (field layout and Pack():24-52 —
NumFields@0:8 | GroupSize@8:8 | UniqueValues@16:1 | CostExponent@17:8 |
MaxValue@25:48 | MinValue@73:48 | MaxValueSum@121:63 | MinValueSum@184:63).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BallotMode:
    num_fields: int = 8
    group_size: int = 0
    unique_values: bool = False
    cost_exponent: int = 1
    max_value: int = 2**16
    min_value: int = 0
    max_value_sum: int = 2**20
    min_value_sum: int = 0

    def validate(self):
        from davinci_tpu_torch import spec

        assert self.num_fields <= spec.FIELDS_PER_BALLOT
        assert self.group_size <= self.num_fields
        assert self.max_value < 1 << 48
        assert self.min_value < 1 << 48
        assert self.max_value_sum < 1 << 63
        assert self.min_value_sum < 1 << 63
        assert self.min_value <= self.max_value
        assert self.cost_exponent in (1, 2), "supported cost exponents: 1, 2"

    def pack(self) -> int:
        self.validate()
        packed = self.num_fields
        packed |= self.group_size << 8
        if self.unique_values:
            packed |= 1 << 16
        packed |= self.cost_exponent << 17
        packed |= self.max_value << 25
        packed |= self.min_value << 73
        packed |= self.max_value_sum << 121
        packed |= self.min_value_sum << 184
        return packed

    @classmethod
    def unpack(cls, packed: int) -> "BallotMode":
        return cls(
            num_fields=packed & 0xFF,
            group_size=(packed >> 8) & 0xFF,
            unique_values=bool((packed >> 16) & 1),
            cost_exponent=(packed >> 17) & 0xFF,
            max_value=(packed >> 25) & ((1 << 48) - 1),
            min_value=(packed >> 73) & ((1 << 48) - 1),
            max_value_sum=(packed >> 121) & ((1 << 63) - 1),
            min_value_sum=(packed >> 184) & ((1 << 63) - 1),
        )
