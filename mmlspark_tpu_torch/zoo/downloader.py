"""Model repository client: manifest -> sha256-verified local cache (the
port of `mmlspark_tpu/zoo/downloader.py`).

A repository is a directory of `.tpubundle` payloads (a deterministic zip
of a ModelBundle directory, `models/bundle.py`) beside `.meta` JSON schemas
(name, dataset, type, uri, sha256, size, input shape, layer names).
Downloading copies a payload into a local cache, verifies its hash, writes
the localized `.meta`, and skips models already cached with a matching
hash.  The formats are the JAX package's, so a repository or cache written
by either package serves the other.

`pretrained_repo()` reads the JAX package's committed trained bundles
(`mmlspark_tpu/zoo/pretrained/`) in place, as data files.  `RemoteRepo`
reads a repository served over HTTP(S) (a directory with a MANIFEST,
`LocalRepo.export_manifest`) through `resilience/net.py` `fetch_url`
(retries, the host's circuit breaker).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import zipfile
from typing import Iterable, Optional

from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              save_bundle)

# the trained bundles the JAX package ships, read in place (never imported)
PRETRAINED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "mmlspark_tpu", "zoo", "pretrained")


class ModelNotFoundError(FileNotFoundError):
    """Reference ModelNotFoundException (ModelDownloader.scala:36-40)."""


@dataclasses.dataclass
class ModelSchema:
    """Reference ModelSchema (Schema.scala:56-76)."""

    name: str
    dataset: str
    modelType: str
    uri: str
    hash: str
    size: int
    inputShape: Optional[list] = None
    numLayers: int = 0
    layerNames: list = dataclasses.field(default_factory=list)

    @property
    def filename(self) -> str:
        return _bundle_filename(self.name, self.dataset)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ModelSchema":
        return ModelSchema(**d)


def _safe_component(part: str) -> str:
    """Reject path-traversal in remote-supplied schema fields: a hostile
    manifest must not be able to steer the cache target outside the cache
    dir (the manifest's sha256 is attacker-chosen, so it offers no
    protection)."""
    if (not part or part in (".", "..") or "/" in part or "\\" in part
            or os.path.basename(part) != part):
        raise ValueError(f"unsafe model schema path component: {part!r}")
    return part


def _bundle_filename(name: str, dataset: str) -> str:
    return f"{_safe_component(name)}_{_safe_component(dataset)}.tpubundle"


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# --------------------------------------------------------------------------
# bundle <-> single-file payload
# --------------------------------------------------------------------------

def pack_bundle(bundle_dir: str, out_path: str) -> str:
    """Zip a bundle directory deterministically (sorted names, zeroed
    timestamps) so equal bundles hash equal."""
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, names in sorted(os.walk(bundle_dir)):
            for name in sorted(names):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, bundle_dir)
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                with open(full, "rb") as f:
                    zf.writestr(info, f.read())
    return out_path


def unpack_bundle(payload_path: str, out_dir: str) -> str:
    with zipfile.ZipFile(payload_path) as zf:
        zf.extractall(out_dir)
    return out_dir


# --------------------------------------------------------------------------
# repositories
# --------------------------------------------------------------------------

class LocalRepo:
    """Directory of .tpubundle payloads + .meta JSON schemas
    (the HDFSRepo analogue, ModelDownloader.scala:43-106)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def list_schemas(self) -> Iterable[ModelSchema]:
        out = []
        for name in sorted(os.listdir(self.path)):
            if name.endswith(".meta"):
                with open(os.path.join(self.path, name)) as f:
                    schema = ModelSchema.from_json(json.load(f))
                # metas store payload URIs relative to the repo dir (the
                # portable CDN layout); resolve for local reads
                if "://" not in schema.uri and not os.path.isabs(schema.uri):
                    schema = dataclasses.replace(
                        schema, uri=os.path.join(self.path, schema.uri))
                out.append(schema)
        return out

    def get_payload(self, schema: ModelSchema) -> bytes:
        path = schema.uri
        if not os.path.exists(path):
            raise ModelNotFoundError(path)
        with open(path, "rb") as f:
            return f.read()

    def add_model(self, bundle: ModelBundle, name: str, dataset: str,
                  model_type: str = "image") -> ModelSchema:
        """Publish a bundle into this repo (addBytes analogue)."""
        payload = os.path.join(self.path, _bundle_filename(name, dataset))
        with tempfile.TemporaryDirectory() as tmp:
            bdir = os.path.join(tmp, "bundle")
            save_bundle(bundle, bdir)
            pack_bundle(bdir, payload)
        meta = bundle.metadata or {}
        schema = ModelSchema(
            name=name, dataset=dataset, modelType=model_type,
            uri=payload, hash=sha256_file(payload),
            size=os.path.getsize(payload),
            inputShape=meta.get("input_shape"),
            numLayers=len(meta.get("layer_names", [])),
            layerNames=list(meta.get("layer_names", [])))
        with open(payload + ".meta", "w") as f:
            # portable layout: the stored URI is relative to the repo dir,
            # so the directory can be served over HTTP (export_manifest) or
            # moved; the returned schema carries the resolved absolute path
            json.dump({**schema.to_json(),
                       "uri": os.path.basename(payload)}, f, indent=1)
        return schema

    def export_manifest(self) -> str:
        """Write a MANIFEST listing the repo's .meta names, making the
        directory directly servable over HTTP for RemoteRepo (the
        reference's CDN layout, ModelDownloader.scala:109-157)."""
        metas = [n for n in sorted(os.listdir(self.path))
                 if n.endswith(".meta")]
        path = os.path.join(self.path, "MANIFEST")
        with open(path, "w") as f:
            f.write("\n".join(metas) + "\n")
        return path


class RemoteRepo:
    """HTTP(S) repository: a MANIFEST lists the `.meta` names (the
    DefaultModelRepo analogue, ModelDownloader.scala:109-157)."""

    def __init__(self, base_url: str, connect_timeout: float = 15.0,
                 read_timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout

    def _fetch(self, rel: str, timeout: Optional[float] = None) -> bytes:
        # the resilience layer's fetch: retry/backoff and the host's
        # circuit breaker, the policy io/remote.py uses
        from mmlspark_tpu_torch.resilience.net import fetch_url
        return fetch_url(f"{self.base_url}/{rel}",
                         timeout=timeout or self.connect_timeout)

    def list_schemas(self) -> Iterable[ModelSchema]:
        manifest = self._fetch("MANIFEST").decode().split()
        return [ModelSchema.from_json(json.loads(self._fetch(name).decode()))
                for name in manifest]

    def get_payload(self, schema: ModelSchema) -> bytes:
        uri = schema.uri
        if "://" in uri:
            # an absolute URI may name a subdirectory or another host than
            # base_url, but a remote-supplied .meta must not steer the
            # client to file:///etc/... or an internal service: http(s)
            # only, the trust level of base_url itself
            import urllib.parse
            if urllib.parse.urlparse(uri).scheme not in ("http", "https"):
                raise ModelNotFoundError(
                    f"refusing non-http(s) payload uri: {uri!r}")
        try:
            if "://" in uri:
                from mmlspark_tpu_torch.resilience.net import fetch_url
                return fetch_url(uri, timeout=self.read_timeout)
            # large payloads get the (longer) read window
            return self._fetch(uri, timeout=self.read_timeout)
        except Exception as e:
            raise ModelNotFoundError(uri) from e


def pretrained_repo() -> LocalRepo:
    """The committed pretrained-model repository, read in place: four
    trained bundles (ConvNet/UCIDigits and ResNetDigits/UCIDigits on the
    UCI handwritten digits, TabularWDBC/WDBC on the UCI breast-cancer
    table, TextSentiment/Reviews over hashed text features), each with its
    dataset, accuracy and, where scoring needs it, its featurization or
    standardization recipe in the bundle metadata."""
    if not os.path.isdir(PRETRAINED_DIR):
        raise ModelNotFoundError(
            f"no pretrained repo at {PRETRAINED_DIR}")
    repo = LocalRepo(PRETRAINED_DIR)
    if not list(repo.list_schemas()):
        raise ModelNotFoundError(
            f"pretrained repo at {PRETRAINED_DIR} is empty")
    return repo


# --------------------------------------------------------------------------
# the downloader
# --------------------------------------------------------------------------

class ModelDownloader:
    """Sync models from a repo into a local cache, verified by sha256."""

    def __init__(self, local_path: Optional[str] = None):
        self.local = LocalRepo(local_path or os.path.join(
            os.path.expanduser("~"), ".cache", "mmlspark_tpu", "models"))

    def local_models(self) -> list[ModelSchema]:
        return list(self.local.list_schemas())

    def remote_models(self, repo) -> list[ModelSchema]:
        return list(repo.list_schemas())

    def download_model(self, repo, schema: ModelSchema,
                       always_download: bool = False) -> ModelSchema:
        """Fetch + verify one model; returns the localized schema.

        Skips the fetch when a cached copy with the same hash exists
        (ModelDownloader.scala:169-181).
        """
        target = os.path.join(self.local.path, schema.filename)
        if (not always_download and os.path.exists(target)
                and sha256_file(target) == schema.hash):
            return self._localized(schema, target)
        data = repo.get_payload(schema)
        digest = hashlib.sha256(data).hexdigest()
        if digest != schema.hash:
            raise ValueError(
                f"downloaded hash {digest} does not match schema hash "
                f"{schema.hash} for model {schema.name} (Schema.scala:35-41)")
        tmp = f"{target}.{os.getpid()}.tmp"  # per-process: concurrent syncs
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, target)
        local_schema = self._localized(schema, target)
        with open(target + ".meta", "w") as f:
            json.dump(local_schema.to_json(), f, indent=1)
        return local_schema

    def download_by_name(self, repo, name: str,
                         always_download: bool = False) -> ModelSchema:
        """ModelDownloader.downloadByName (scala:236-242)."""
        for schema in repo.list_schemas():
            if schema.name == name:
                return self.download_model(repo, schema, always_download)
        raise ModelNotFoundError(name)

    def load_bundle(self, schema: ModelSchema) -> ModelBundle:
        """Unpack a localized schema's payload into a ModelBundle."""
        with tempfile.TemporaryDirectory() as tmp:
            unpack_bundle(schema.uri, tmp)
            return load_bundle(tmp)

    @staticmethod
    def _localized(schema: ModelSchema, target: str) -> ModelSchema:
        return dataclasses.replace(schema, uri=target)


# --------------------------------------------------------------------------
# built-in zoo
# --------------------------------------------------------------------------

_BUILTIN_SPECS = [
    # (name, dataset, architecture, config, input_shape, layer_names)
    ("ConvNet", "CIFAR10", "ConvNetCIFAR10", {},
     [1, 32, 32, 3], ["z", "dense1", "pool3", "pool2", "pool1"]),
    ("ResNet18", "ImageNet", "ResNet",
     {"stage_sizes": [2, 2, 2, 2], "widths": [64, 128, 256, 512]},
     [1, 224, 224, 3], ["z", "pool", "stage4", "stage3", "stage2", "stage1"]),
    ("ResNet50", "ImageNet", "ResNet",
     {"stage_sizes": [3, 4, 6, 3], "widths": [64, 128, 256, 512],
      "block_kind": "bottleneck"},
     [1, 224, 224, 3], ["z", "pool", "stage4", "stage3", "stage2", "stage1"]),
    ("MLP", "Generic", "MLPClassifier", {"hidden_sizes": [100]},
     [1, 16], ["z", "h0"]),
]


def create_builtin_repo(path: str, seed: int = 0,
                        include: Optional[list] = None) -> LocalRepo:
    """Materialize the built-in architecture zoo as a local repo.

    Weights are seed-initialized (`ModelBundle.init`).  `include` limits
    materialization to the named models (big nets like ResNet50 take
    seconds to init + pack).
    """
    repo = LocalRepo(path)
    existing = {(s.name, s.dataset) for s in repo.list_schemas()}
    for name, dataset, arch, config, input_shape, layer_names in _BUILTIN_SPECS:
        if (name, dataset) in existing:
            continue
        if include is not None and name not in include:
            continue
        bundle = ModelBundle.init(arch, config, seed=seed,
                                  metadata={"input_shape": input_shape,
                                            "layer_names": layer_names,
                                            "pretrained": False},
                                  input_shape=tuple(input_shape))
        repo.add_model(bundle, name, dataset)
    return repo
