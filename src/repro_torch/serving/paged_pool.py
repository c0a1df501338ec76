"""Paged KV pool: the device-side staging area between the LSM store and
the paged decode-attention kernel.

Disk-resident KV blocks promoted by the cache hierarchy land in a paged
pool on the device; sequences reference pages through block tables that
``repro_torch.kernels.decode_attention`` reads directly.  The pool is a
classic free-list allocator with per-sequence tables, with the
reference's semantics:

    alloc(seq_id, n_pages) / extend(seq_id) / free(seq_id)
    stage_block(seq_id, token_offset, k_block, v_block)   host -> pool page
    block_tables(batch_of_seq_ids) -> (B, NB) int32 (padded with page 0)

Pages hold (page_size, KVH, Dh) per layer.  Storage is (L, P, page, KVH,
Dh), so ``layer_view(l)`` is a contiguous (P, page, KVH, Dh) operand for
the kernel with no copy (the reference stores (P, L, page, KVH, Dh)).  The
pool refuses allocation when full (the caller demotes and retries).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch


class PoolFullError(RuntimeError):
    pass


@dataclass
class PagedKVPool:
    n_pages: int
    page_size: int  # tokens per page
    n_layers: int
    n_kv_heads: int
    d_head: int
    dtype: torch.dtype = torch.float16
    device: str = "cuda"

    def __post_init__(self):
        shape = (self.n_layers, self.n_pages, self.page_size, self.n_kv_heads, self.d_head)
        self.k_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}

    # ------------------------------------------------------------ allocator
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, seq_id: int, n_pages: int) -> List[int]:
        if n_pages > len(self._free):
            raise PoolFullError(f"need {n_pages}, free {len(self._free)}")
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        pages = [self._free.pop() for _ in range(n_pages)]
        self._tables[seq_id] = pages
        self._lens[seq_id] = 0
        return pages

    def extend(self, seq_id: int) -> int:
        if not self._free:
            raise PoolFullError("pool exhausted")
        p = self._free.pop()
        self._tables[seq_id].append(p)
        return p

    def free(self, seq_id: int) -> None:
        for p in self._tables.pop(seq_id):
            self._free.append(p)
        self._lens.pop(seq_id, None)

    # -------------------------------------------------------------- staging
    def stage_block(self, seq_id: int, token_offset: int, k, v) -> None:
        """Write a (L, n_tok, KVH, Dh) block (tensor or numpy array) at
        ``token_offset`` within the sequence (n_tok <= page_size; blocks
        never straddle pages when block_size == page_size, the default
        wiring)."""
        page_idx = token_offset // self.page_size
        within = token_offset % self.page_size
        n_tok = k.shape[1]
        assert within + n_tok <= self.page_size, "block straddles a page"
        page = self._tables[seq_id][page_idx]
        self.k_pages[:, page, within:within + n_tok] = torch.as_tensor(k).to(self.device, self.dtype)
        self.v_pages[:, page, within:within + n_tok] = torch.as_tensor(v).to(self.device, self.dtype)
        self._lens[seq_id] = max(self._lens[seq_id], token_offset + n_tok)

    def append_token(self, seq_id: int, k, v) -> None:
        """Decode step: append one token's (L, KVH, Dh) KV, extending the
        table when the tail page is full."""
        pos = self._lens[seq_id]
        if pos // self.page_size >= len(self._tables[seq_id]):
            self.extend(seq_id)
        self.stage_block(seq_id, pos, k[:, None], v[:, None])

    # ---------------------------------------------------------- kernel view
    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def block_tables(self, seq_ids: Sequence[int]) -> torch.Tensor:
        """(B, NB) int32 page-id table on the pool's device, padded with
        page 0 (masked by kv_len in the kernel)."""
        nb = max(len(self._tables[s]) for s in seq_ids)
        out = torch.zeros((len(seq_ids), nb), dtype=torch.int32)
        for i, s in enumerate(seq_ids):
            t = self._tables[s]
            out[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        return out.to(self.device)

    def kv_lens(self, seq_ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor([self._lens[s] for s in seq_ids], dtype=torch.int32, device=self.device)

    def layer_view(self, layer: int):
        """(P, page, KVH, Dh) contiguous views for one layer — the kernel's
        operands."""
        return self.k_pages[layer], self.v_pages[layer]
