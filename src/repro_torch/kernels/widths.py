"""Zero-padding to the widths a kernel takes, for the attention, decode,
chunk-prefix and MLA kernel wrappers.

The attention kernels take a head dim D in {32, 64, 128} (the decode
kernels at most 16 query rows a KV head), the MLA kernels a latent rank r
in {32, ..., 512} and a rope width in {32, 64}.  A narrower width (the
reduced configs' D 16, r 16, rope 8) is zero-padded to the next width the
kernel takes: zeros in a query and a key change no dot product, and
zeros in a value (MLA's value is the latent row) give zero output
columns, which are sliced off.  The softmax scale is the caller's,
computed at the true width.  Nothing is copied where every width is
native.
"""
from __future__ import annotations


def native_width(d: int, widths, kernel: str) -> int:
    """The least of ``widths`` (ascending) that holds ``d``."""
    for w in widths:
        if d <= w:
            return w
    raise ValueError(f"{kernel}: width {d} is past the widest the kernel "
                     f"takes ({widths[-1]})")


def pad_last(t, width: int):
    """``t`` zero-padded on its last dim to ``width``: ``t`` itself when it
    is that wide already, else a copy."""
    import torch.nn.functional as F

    d = t.shape[-1]
    return t if d == width else F.pad(t, (0, width - d))


def at_widths(fn, groups, kernel: str, *, max_group=None):
    """``fn(*operands)`` with every operand at a width the kernel takes.

    ``groups`` is a sequence of ``(tensors, widths)``: the tensors of a
    group share their last dim, which is padded to the least of
    ``widths`` (ascending) that holds it, and they reach ``fn`` in group
    order.  The output (the first of a tuple) is sliced back to the
    first group's true width.  With ``max_group``, the first operand's
    dim 1 (the query rows of a KV head, which are independent) goes to
    ``fn`` in slices of at most that many rows, one launch each, and the
    partials are concatenated on dim 1."""
    import torch

    args = []
    for tensors, widths in groups:
        w = native_width(tensors[0].shape[-1], widths, kernel)
        args += [pad_last(t, w) for t in tensors]
    q, rest = args[0], args[1:]
    G = q.shape[1]
    if max_group is None or G <= max_group:
        out = fn(q, *rest)
    else:
        parts = [fn(q[:, g:g + max_group].contiguous(), *rest)
                 for g in range(0, G, max_group)]
        out = tuple(torch.cat(p, 1) for p in zip(*parts))
    d = groups[0][0][0].shape[-1]
    first = out[0] if isinstance(out, tuple) else out
    if first.shape[-1] == d:
        return out
    first = first[..., :d].contiguous()
    return (first, *out[1:]) if isinstance(out, tuple) else first
