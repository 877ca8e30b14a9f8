"""One iteration of SCDL's ADMM at its shapes.

For K sample pairs of P and M pixels and A atoms:

- bytes: the patches S_h and S_l read once; the carried multipliers
  (Y1, Y2, Y3 and the two right-hand sides Z1, Z2: five K x A planes)
  read once and written once; 4 bytes each.  The codes W_h, W_l are
  recomputed every iteration from the carried planes and need never
  leave the chip; the dictionaries (A (P + M) numbers) are counted once.
- matrix products: each code update is the cheaper of the two exact
  forms, dense (2 K A (P + A): the right-hand side and the A x A
  inverse) or thin (6 K P A: right-hand side, and the rank-P Woodbury
  correction); the four outer products S^T W (2 K P A, 2 K M A) and
  W^T W (K A^2 each, symmetric); the small factorizations (an A x A
  Cholesky, A^3 / 3, and its solve against P or M columns, 2 A^2 P, per
  dictionary and per ridge).
- other operations: the soft thresholds and the three dual steps, 24
  operations an entry of K x A.
"""
from __future__ import annotations


def _ridge(K, P, A):
    return min(2 * K * A * (P + A), 6 * K * P * A)


def per_iteration(shapes: dict) -> dict:
    K, P, M, A = (int(shapes[k]) for k in ("K", "p_dim", "m_dim", "n_atoms"))
    nbytes = 4 * (K * (P + M) + 2 * 5 * K * A + 2 * A * (P + M))
    small = sum(A ** 3 / 3 + 2 * A * A * d for d in (P, M)) * 2
    matmul = (_ridge(K, P, A) + _ridge(K, M, A)
              + 2 * K * P * A + 2 * K * M * A + 2 * K * A * A + small)
    return {"bytes": float(nbytes), "matmul_flops": float(matmul),
            "flops": float(24 * K * A)}
