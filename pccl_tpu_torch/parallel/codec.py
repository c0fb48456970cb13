"""Parameter dict <-> one flat fp32 vector.

DiLoCo moves the whole pseudo-gradient over the ring as one contiguous fp32
buffer. The leaf order is JAX's (`jax.tree.flatten` of a dict sorts its
keys), so a flat vector here lines up element for element with the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Codec:
    """Flatten/unflatten shaped to a template dict."""

    def __init__(self, template: Dict[str, torch.Tensor]):
        self.names = sorted(template)
        self.shapes = [tuple(template[n].shape) for n in self.names]
        self.dtypes = [template[n].dtype for n in self.names]
        self.sizes = [template[n].numel() for n in self.names]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]
        self.count = sum(self.sizes)

    def _slices(self):
        return zip(self.names, self.offsets, self.sizes, self.shapes, self.dtypes)

    def flat(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """fp32 [count] vector, leaves in sorted-name order."""
        return torch.cat([params[n].detach().float().reshape(-1)
                          for n in self.names])

    @torch.no_grad()
    def flat_into(self, params: Dict[str, torch.Tensor], out: torch.Tensor) -> torch.Tensor:
        """flat(params), written leaf by leaf into the fp32 vector `out`."""
        for n, o, s, _, _ in self._slices():
            out[o:o + s].copy_(params[n].detach().reshape(-1))
        return out

    def unflat(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fresh tensors, each cast back to its template dtype."""
        return {n: vec[o:o + s].reshape(shp).to(dt, copy=True)
                for n, o, s, shp, dt in self._slices()}

    @torch.no_grad()
    def unflat_into(self, vec: torch.Tensor, params: Dict[str, torch.Tensor]) -> None:
        """Write vec into the existing tensors of `params`, in place."""
        for n, o, s, shp, _ in self._slices():
            params[n].copy_(vec[o:o + s].reshape(shp))

    @torch.no_grad()
    def flat_delta_vec(self, outer_vec: torch.Tensor,
                       inner: Dict[str, torch.Tensor],
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """outer_vec - flat(inner), written leaf by leaf into `out` (no
        flattened copy of inner is made)."""
        if out is None:
            out = torch.empty_like(outer_vec)
        for n, o, s, _, _ in self._slices():
            torch.sub(outer_vec[o:o + s], inner[n].detach().reshape(-1),
                      out=out[o:o + s])
        return out


def build_codec(template: Dict[str, torch.Tensor]) -> Codec:
    return Codec(template)
