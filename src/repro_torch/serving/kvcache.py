"""Paged KV-cache accounting (control plane) + slot allocator (real engine).

The block pool is the vLLM-style paged allocator: requests reserve
block_size-token pages; usage fraction is the ``kv_usage`` trace signal and
drives both the KV-protection path in Algorithm 1 and preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class BlockPool:
    def __init__(self, total_tokens: int, block_size: int = 16):
        self.block_size = block_size
        self.total_blocks = max(total_tokens // block_size, 1)
        self.free_blocks = self.total_blocks
        self._held: Dict[int, int] = {}   # req_id -> blocks held
        # cumulative physical allocations (prefix-sharing benches compare
        # this across sharing on/off runs)
        self.stat_blocks_allocated = 0
        # prefix-sharing telemetry, defined on EVERY pool (zero on plain
        # ones) so cluster aggregation reads them directly instead of
        # getattr-defaulting — a pool that "never shares" and a pool that
        # silently lost the field must not look alike
        self.stat_cow_copies = 0
        self.stat_hit_pages = 0
        self.stat_hit_tokens = 0          # token-granular cache-hit tokens
        self.stat_hit_tokens_page = 0     # the page-aligned part of those

    @staticmethod
    def blocks_for(tokens: int, block_size: int) -> int:
        return -(-max(tokens, 1) // block_size)

    def can_allocate(self, req_id: int, tokens: int) -> bool:
        need = self.blocks_for(tokens, self.block_size) \
            - self._held.get(req_id, 0)
        return need <= self.free_blocks

    def allocate(self, req_id: int, tokens: int) -> bool:
        """Grow req's reservation to cover ``tokens`` total. False if OOM."""
        need = self.blocks_for(tokens, self.block_size) \
            - self._held.get(req_id, 0)
        if need > self.free_blocks:
            return False
        if need > 0:
            self.free_blocks -= need
            self._held[req_id] = self._held.get(req_id, 0) + need
            self.stat_blocks_allocated += need
        return True

    def free(self, req_id: int) -> None:
        self.free_blocks += self._held.pop(req_id, 0)

    @property
    def usage(self) -> float:
        return 1.0 - self.free_blocks / self.total_blocks

    def held_tokens(self, req_id: int) -> int:
        return self._held.get(req_id, 0) * self.block_size


class SlotAllocator:
    """Fixed-slot cache rows for the real (tiny-model) engine: the batched
    decode call uses cache arrays (n_slots, ...) indexed by slot id."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free = list(range(n_slots))[::-1]
        self._of: Dict[int, int] = {}

    def acquire(self, req_id: int) -> Optional[int]:
        if req_id in self._of:
            return self._of[req_id]
        if not self._free:
            return None
        slot = self._free.pop()
        self._of[req_id] = slot
        return slot

    def release(self, req_id: int) -> None:
        slot = self._of.pop(req_id, None)
        if slot is not None:
            self._free.append(slot)

    def slot_of(self, req_id: int) -> Optional[int]:
        return self._of.get(req_id)
