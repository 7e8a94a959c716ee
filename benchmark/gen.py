"""The cells' data, drawn on the device.

The draws are bench.py's: uniform feature columns,
N(0, 1) values, a planted model w ~ N(0, 0.25), and labels drawn from the
planted logistic model. They are made with a ``torch.Generator`` on the
device in a few large calls, never on the host.

A cell's rows are drawn once from its traffic's ``data_seed``; the run's
``--seed`` then gives every feature a sign of its own: its values are
multiplied by it. Flipping a
feature's sign, and its coefficient's with it, is an exact symmetry of the
fit in IEEE arithmetic: every margin, loss and norm comes out bit for bit
the same, and every coefficient and gradient with the feature's sign. So
no two seeds give a fit the same inputs or the same answer, and every seed
gives it the same work: the same iterations, stops and line searches (an
order of the rows would change the sums' rounding, and with it where a
solve at tolerance 0 stops). The planted model has a generator of its own,
seeded by the data seed alone, so every row shard shares it; each shard's
rows come from a generator seeded by the data seed and the shard; the
signs come from one seeded by the run's seed alone, the same on every card.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# rows per block of the planted margins (bounds the temporaries)
_BLOCK_ROWS = 1 << 22


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed``; any whole
    number seed, however large, maps into the generator's 64 bits."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream) * 7_919 + 1) % (1 << 63))
    return g


@dataclasses.dataclass
class SparseRows:
    """Rows of a fixed number of nonzeros each: row i holds
    ``cols[i*k:(i+1)*k]`` and ``vals[i*k:(i+1)*k]``."""

    cols: Tensor  # i32[n*k]
    vals: Tensor  # f32[n*k]
    labels: Tensor  # f32[n]
    num_features: int
    nnz_per_row: int

    @property
    def num_rows(self) -> int:
        return int(self.labels.shape[0])

    def row_ptr(self) -> Tensor:
        """The CSR row pointer (int32) of these rows."""
        k = self.nnz_per_row
        return torch.arange(0, self.num_rows * k + 1, k, dtype=torch.int32,
                            device=self.vals.device)

    def rows(self, start: int, stop: int) -> "SparseRows":
        k = self.nnz_per_row
        return SparseRows(self.cols[start * k:stop * k], self.vals[start * k:stop * k],
                          self.labels[start:stop], self.num_features, k)


def planted(seed: int, num_features: int, device) -> Tensor:
    """The planted fixed-effect model, w ~ N(0, 0.25) (f32[F])."""
    return torch.randn(num_features, generator=generator(seed, 0, device),
                       device=device) * 0.5


def sparse_margins(cols: Tensor, vals: Tensor, w: Tensor, k: int) -> Tensor:
    """x_i . w of rows of ``k`` nonzeros each, in blocks (float32)."""
    n = vals.shape[0] // k
    out = torch.empty(n, dtype=torch.float32, device=vals.device)
    for s in range(0, n, _BLOCK_ROWS):
        e = min(n, s + _BLOCK_ROWS)
        out[s:e] = (vals[s * k:e * k] * w[cols[s * k:e * k].long()]).view(e - s, k).sum(1)
    return out


def draw_labels(margins: Tensor, g: torch.Generator) -> Tensor:
    """y ~ Bernoulli(sigmoid(margin)), as float32 0/1."""
    u = torch.rand(margins.shape[0], generator=g, device=margins.device)
    return (u < torch.sigmoid(margins)).to(torch.float32)


def signs(seed: int, shape, stream: int, device) -> Tensor:
    """The run's signs, +1 or -1 (f32), of ``shape`` from ``seed``."""
    bits = torch.randint(0, 2, shape, generator=generator(seed, stream, device),
                         device=device, dtype=torch.int32)
    return (1 - 2 * bits).to(torch.float32)


def feature_signs(seed: int, num_features: int, device) -> Tensor:
    """The seed's sign of each fixed-effect feature (f32[F])."""
    return signs(seed, (num_features,), 1000, device)


def orient(rows: SparseRows, seed: int) -> SparseRows:
    """``rows`` with every feature's values times the seed's sign for it."""
    s = feature_signs(seed, rows.num_features, rows.vals.device)
    step = _BLOCK_ROWS * rows.nnz_per_row
    for i in range(0, rows.vals.shape[0], step):
        rows.vals[i:i + step].mul_(s[rows.cols[i:i + step].long()])
    return rows


def glm_rows(data_seed: int, seed: int, shard: int, num_rows: int, num_features: int,
             nnz_per_row: int, device) -> SparseRows:
    """Shard ``shard`` of a GLM's rows (bench.py's draws from ``data_seed``),
    oriented by ``seed``."""
    g = generator(data_seed, 1 + shard, device)
    nnz = num_rows * nnz_per_row
    cols = torch.randint(0, num_features, (nnz,), generator=g, device=device,
                         dtype=torch.int32)
    vals = torch.randn(nnz, generator=g, device=device)
    w_true = planted(data_seed, num_features, device)
    labels = draw_labels(sparse_margins(cols, vals, w_true, nnz_per_row), g)
    return orient(SparseRows(cols, vals, labels, num_features, nnz_per_row), seed)
