# Copy of ceph_tpu/ec/plugins/lrc.py at commit 6e1c6d1, with its ceph_tpu
# import statements rebound to ceph_tpu_torch and the codec's device passed
# on to every layer's factory (ec/registry.py).
"""LRC plugin: Locally Repairable Codes by layered plugin composition.

Equivalent of the reference's lrc plugin (reference
src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): a composite codec described by
a JSON ``layers`` array.  Each layer is ``[chunks_map, profile]`` where
chunks_map is a string over the global chunk positions ('D' = the layer's
data input, 'c' = a parity this layer computes, '_' = not in this layer)
and profile configures the inner codec, instantiated THROUGH THE REGISTRY
(layers_init, ErasureCodeLrc.cc:210) — plugin composition is first-class,
so a layer can use jerasure, isa, shec, or the cuda plugin.

The ``mapping`` profile string defines which global positions hold object
data ('D') vs parity; k = count of 'D'.  The k/m/l shorthand generates
mapping + layers: one global MDS layer over all k data chunks plus
(k+m)/l local XOR-ish groups of l chunks each with one local parity
(parse_kml, ErasureCodeLrc.cc:300-380).

encode walks layers in order, remapping global ids to per-layer local ids
(encode_chunks, ErasureCodeLrc.cc:649-688).  decode iterates layers in
reverse, resolving erasures locally when a layer has few enough of them,
reusing chunks recovered by earlier layers (decode_chunks,
ErasureCodeLrc.cc:690-775).  _minimum_to_decode is locality-aware: losing
one chunk reads only its local group (ErasureCodeLrc.cc:565-647).
"""

from __future__ import annotations

import errno
import json
from typing import Dict, List, Mapping, Optional, Set

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec.base import ErasureCode, to_int
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan
from ceph_tpu_torch.ec.registry import ErasureCodePlugin

DEFAULT_KML = -1


class Layer:
    def __init__(self, chunks_map: str, profile: ErasureCodeProfile):
        self.chunks_map = chunks_map
        self.profile = dict(profile)
        self.data = [i for i, ch in enumerate(chunks_map) if ch == "D"]
        self.coding = [i for i, ch in enumerate(chunks_map) if ch == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        self.erasure_code = None  # set by layers_init


class ErasureCodeLrc(ErasureCode):
    plugin_name = "lrc"

    def __init__(self, directory: str = "", device=None):
        super().__init__()
        self.directory = directory
        self.device = device  # passed on to every layer's factory
        self.layers: List[Layer] = []
        self.mapping = ""
        self._chunk_count = 0

    # -- geometry ------------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self._chunk_count - self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        """Delegates to the first (global) layer's codec
        (ErasureCodeLrc.cc:560-563)."""
        return self.layers[0].erasure_code.get_chunk_size(stripe_width)

    # -- profile parsing -----------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        self._parse_kml(profile)
        description = profile.get("layers")
        if not description:
            raise ErasureCodeError(
                -errno.EINVAL, "could not find 'layers' in profile"
            )
        self._layers_parse(description)
        self._layers_init()
        self.mapping = profile.get("mapping", "")
        if not self.mapping:
            raise ErasureCodeError(
                -errno.EINVAL, "the 'mapping' profile is missing"
            )
        self.k = self.mapping.count("D")
        self._chunk_count = len(self.mapping)
        self._layers_sanity_checks()
        self.parse_chunk_mapping(profile)
        # kml-generated internals are not exposed back to the caller
        # (ErasureCodeLrc.cc:538-542)
        if profile.get("l") not in (None, str(DEFAULT_KML)):
            profile.pop("mapping", None)
            profile.pop("layers", None)
        profile["plugin"] = self.plugin_name
        self._profile = profile

    def _parse_kml(self, profile: ErasureCodeProfile) -> None:
        """k/m/l shorthand -> generated mapping + layers
        (parse_kml, ErasureCodeLrc.cc:300-380)."""
        k = to_int(profile, "k", DEFAULT_KML)
        m = to_int(profile, "m", DEFAULT_KML)
        l = to_int(profile, "l", DEFAULT_KML)
        if k == DEFAULT_KML and m == DEFAULT_KML and l == DEFAULT_KML:
            return
        if DEFAULT_KML in (k, m, l):
            raise ErasureCodeError(
                -errno.EINVAL, "all of k, m, l must be set or none of them"
            )
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"the {generated} parameter cannot be set when k, m, l are set",
                )
        if l == 0 or (k + m) % l:
            raise ErasureCodeError(-errno.EINVAL, "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeError(
                -errno.EINVAL, "k must be a multiple of (k + m) / l"
            )
        if m % groups:
            raise ErasureCodeError(
                -errno.EINVAL, "m must be a multiple of (k + m) / l"
            )
        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = [["".join(("D" * kg + "c" * mg + "_") for _ in range(groups)), ""]]
        for i in range(groups):
            row = "".join(
                ("D" * l + "c") if i == j else "_" * (l + 1) for j in range(groups)
            )
            layers.append([row, ""])
        profile["layers"] = json.dumps(layers)

    def _layers_parse(self, description: str) -> None:
        """JSON layers array (layers_parse, ErasureCodeLrc.cc:140-208)."""
        try:
            parsed = json.loads(description)
        except json.JSONDecodeError as e:
            raise ErasureCodeError(
                -errno.EINVAL, f"layers is not valid JSON: {e}"
            ) from e
        if not isinstance(parsed, list):
            raise ErasureCodeError(-errno.EINVAL, "layers must be a JSON array")
        for position, entry in enumerate(parsed):
            if not isinstance(entry, list) or not entry:
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"layers[{position}] must be a non-empty JSON array",
                )
            chunks_map = entry[0]
            if not isinstance(chunks_map, str):
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"layers[{position}][0] must be a string (the chunks map)",
                )
            layer_profile: ErasureCodeProfile = {}
            if len(entry) > 1:
                raw = entry[1]
                if isinstance(raw, str):
                    # space-separated k=v pairs, same as profile strings
                    for part in raw.split():
                        if "=" not in part:
                            raise ErasureCodeError(
                                -errno.EINVAL,
                                f"layers[{position}][1]: expected k=v, got {part!r}",
                            )
                        key, value = part.split("=", 1)
                        layer_profile[key] = value
                elif isinstance(raw, dict):
                    layer_profile = {str(kk): str(vv) for kk, vv in raw.items()}
                else:
                    raise ErasureCodeError(
                        -errno.EINVAL,
                        f"layers[{position}][1] must be a string or object",
                    )
            self.layers.append(Layer(chunks_map, layer_profile))

    def _layers_init(self) -> None:
        """Instantiate each layer's inner codec through the registry
        (layers_init, ErasureCodeLrc.cc:210-244)."""
        from ceph_tpu_torch.ec.registry import registry

        for layer in self.layers:
            prof = dict(layer.profile)
            prof.setdefault("k", str(len(layer.data)))
            prof.setdefault("m", str(len(layer.coding)))
            prof.setdefault("plugin", "jerasure")
            prof.setdefault("technique", "reed_sol_van")
            layer.erasure_code = registry.factory(
                prof["plugin"], self.directory, prof, device=self.device
            )

    def _layers_sanity_checks(self) -> None:
        """layers_sanity_checks (ErasureCodeLrc.cc:246-276), plus coverage
        checks so every misconfiguration fails at init() with EINVAL rather
        than surfacing as a KeyError on first encode: every parity position
        must be computed by some layer, and each layer may only read
        positions that are object data or parities computed by an EARLIER
        layer (encode walks layers in order)."""
        if not self.layers:
            raise ErasureCodeError(
                -errno.EINVAL, "layers must contain at least one layer"
            )
        for position, layer in enumerate(self.layers):
            if len(layer.chunks_map) != self._chunk_count:
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"layers[{position}] has {len(layer.chunks_map)} chunks, "
                    f"mapping has {self._chunk_count}",
                )
        data_positions = {i for i, ch in enumerate(self.mapping) if ch == "D"}
        known = set(data_positions)
        for position, layer in enumerate(self.layers):
            unknown = set(layer.data) - known
            if unknown:
                raise ErasureCodeError(
                    -errno.EINVAL,
                    f"layers[{position}] reads positions {sorted(unknown)} "
                    "that are neither object data nor computed by an "
                    "earlier layer",
                )
            known |= set(layer.coding)
        uncovered = set(range(self._chunk_count)) - known
        if uncovered:
            raise ErasureCodeError(
                -errno.EINVAL,
                f"mapping positions {sorted(uncovered)} are not computed "
                "by any layer",
            )

    # -- chunk selection (locality-aware) ------------------------------------

    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> SubChunkPlan:
        """Port of _minimum_to_decode (ErasureCodeLrc.cc:565-647)."""
        all_chunks = set(range(self._chunk_count))
        erasures_total = all_chunks - available
        erasures_want = erasures_total & want_to_read

        # Case 1: nothing wanted is missing
        if not erasures_want:
            return self._full_chunk_plan(set(want_to_read))

        # Case 2: recover wanted erasures with as few chunks as possible,
        # walking layers in reverse (most local first)
        minimum: Set[int] = set()
        erasures_not_recovered = set(erasures_total)
        remaining_want = set(erasures_want)
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures_want = layer_want & remaining_want
            if not layer_erasures_want:
                minimum |= layer_want
                continue
            erasures = layer.chunks_as_set & erasures_not_recovered
            if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                continue  # too many for this layer; hope an upper layer helps
            minimum |= layer.chunks_as_set - erasures_not_recovered
            erasures_not_recovered -= erasures
            remaining_want -= erasures
        if not remaining_want:
            minimum |= want_to_read
            minimum -= erasures_total
            return self._full_chunk_plan(minimum)

        # Case 3: chain recovery across layers that do not contain wanted
        # chunks, then fall back to all available chunks.  Iterated to a
        # fixpoint (vs the reference's single pass, ErasureCodeLrc.cc:608-645)
        # to match decode_chunks' chained-recovery ability.
        erasures = set(erasures_total)
        progress = True
        while erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_as_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) <= layer.erasure_code.get_coding_chunk_count():
                    erasures -= layer_erasures
                    progress = True
        if not erasures:
            return self._full_chunk_plan(set(available))

        raise ErasureCodeError(
            -errno.EIO,
            f"not enough chunks in {sorted(available)} to read "
            f"{sorted(want_to_read)}",
        )

    # -- encode / decode -----------------------------------------------------

    def encode(self, want_to_encode: Set[int], data: bytes) -> Dict[int, np.ndarray]:
        n = self._chunk_count
        bad = {c for c in want_to_encode if c >= n}
        if bad:
            raise ErasureCodeError(-errno.EINVAL, f"invalid chunk ids {bad}")
        blocksize = self.get_chunk_size(len(data))
        carved = self.encode_prepare(data, blocksize)
        values: Dict[int, np.ndarray] = {}
        for i in range(self.k):
            values[self.chunk_index(i)] = carved[i]
        self._encode_layers(values, blocksize)
        return {c: values[c] for c in want_to_encode}

    def _encode_layers(self, values: Dict[int, np.ndarray], blocksize: int) -> None:
        """Walk layers in order, computing each layer's parities from its
        local view (encode_chunks, ErasureCodeLrc.cc:649-688)."""
        for layer in self.layers:
            local_data = np.stack([values[c] for c in layer.data])
            coding = layer.erasure_code.encode_chunks(local_data)
            for j, c in enumerate(layer.coding):
                values[c] = coding[j]

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        """Raw path: [k, B] data in logical order -> parities in physical
        coding-position order."""
        values: Dict[int, np.ndarray] = {
            self.chunk_index(i): data[i] for i in range(self.k)
        }
        self._encode_layers(values, data.shape[1])
        coding_positions = [
            p for p in range(self._chunk_count) if self.mapping[p] != "D"
        ]
        return np.stack([values[p] for p in coding_positions])

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        """Iterative reverse-layer recovery reusing chunks recovered by
        deeper layers (decode_chunks, ErasureCodeLrc.cc:690-775)."""
        n = self._chunk_count
        values: Dict[int, np.ndarray] = {
            c: np.asarray(v, dtype=np.uint8) for c, v in chunks.items()
        }
        erasures = set(range(n)) - set(values)
        want_missing = set(want_to_read) & erasures
        # Improvement over the reference's single reverse pass
        # (ErasureCodeLrc.cc:705-759): iterate to a fixpoint so chained
        # recoveries land — e.g. the global layer rebuilds a data chunk
        # that then lets its local group rebuild the group's parity.
        progress = True
        while want_missing and progress:
            progress = False
            for layer in reversed(self.layers):
                if not want_missing:
                    break
                layer_erasures = layer.chunks_as_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) > layer.erasure_code.get_coding_chunk_count():
                    continue
                local_want = {layer.chunks.index(c) for c in layer_erasures}
                local_chunks = {
                    j: values[c]
                    for j, c in enumerate(layer.chunks)
                    if c in values
                }
                local_decoded = layer.erasure_code.decode_chunks(
                    local_want, local_chunks
                )
                for j, c in enumerate(layer.chunks):
                    if j in local_decoded:
                        values[c] = local_decoded[j]
                erasures -= layer.chunks_as_set
                want_missing = set(want_to_read) - set(values)
                progress = True
        if want_missing:
            raise ErasureCodeError(
                -errno.EIO,
                f"unable to read {sorted(want_missing)} from "
                f"{sorted(chunks)}",
            )
        return {c: values[c] for c in want_to_read}

    # lrc's decode_chunks speaks physical ids directly (layers address
    # global positions); base.decode skips the logical remap
    decode_chunks_id_space = "physical"

    # -- placement -----------------------------------------------------------

    def create_rule(self, name: str, crush) -> int:
        return crush.add_simple_rule(
            name, root="default", failure_domain="host", mode="indep"
        )


class LrcPlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        codec = ErasureCodeLrc(directory=profile.get("directory", ""),
                               device=device)
        codec.init(dict(profile))
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, LrcPlugin())
    return 0
