"""The port's deployment layer (container_engine_accelerators_tpu_torch/
deploy/): its Kubernetes manifests against the port's modules and the
reference's manifests.

  (a) every YAML file parses, and every container that runs a port
      module (`python3 -m container_engine_accelerators_tpu_torch.<m>`)
      has a command that the module's own `parse_args` accepts;
  (b) the LM server's flags equal the reference manifest's SERVE_*
      values (demo/serving/jax-serving-lm.yaml), one case per variable,
      and its training Job trains the model the server loads;
  (c) every pod asks for nvidia.com/gpu and never google.com/tpu, and
      selects nodes by cloud.google.com/gke-accelerator;
  (d) every path a flag names is mounted (the plugin's driver directory
      as a hostPath at --container-path), and every container of a
      kernel-building image mounts the package's kernel build directory;
  (e) every image of the repo's own registry path has a Dockerfile here
      whose COPY sources exist;
  (f) every reference manifest and Dockerfile is mapped to a file here
      or listed as not ported, with its reason (deploy/README.md).
"""

import importlib
import os
import re
import shlex

import pytest
import yaml

from container_engine_accelerators_tpu_torch.ops import _build
from container_engine_accelerators_tpu_torch.plugin import podresources

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "container_engine_accelerators_tpu_torch"
DEPLOY = os.path.join(ROOT, PKG, "deploy")
APP = "/app"  # the images' WORKDIR, where the package sits
IMAGE = re.compile(r"^gcr\.io/PROJECT/([a-z0-9-]+):[\w.-]+$")
EXTERNAL_IMAGES = {"gcr.io/google-containers/pause:3.9"}
KERNEL_IMAGES = {"torch-training-demo", "torch-serving-demo"}
KERNELS_DIR = os.path.join(
    APP, os.path.relpath(_build.BUILD_DIR, os.path.dirname(_build._PKG)))
POD_KINDS = {"Deployment", "Job", "StatefulSet", "DaemonSet"}
# The reference's deployment layer: its manifests and images.
REFERENCE_DIRS = ("cmd", "demo", "test", "example", "libtpu-installer")


def _manifests():
    return sorted(f for f in os.listdir(DEPLOY) if f.endswith(".yaml"))


def _docs(name):
    with open(os.path.join(DEPLOY, name)) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _pods():
    """(file, object name, pod spec) of every workload object here."""
    out = []
    for name in _manifests():
        for doc in _docs(name):
            if doc["kind"] in POD_KINDS:
                out.append((name, doc["metadata"]["name"],
                            doc["spec"]["template"]["spec"]))
    return out


def _containers():
    """(file, pod spec, container) of every container and init
    container here."""
    return [(name, spec, c) for name, _, spec in _pods()
            for c in spec.get("initContainers", []) + spec["containers"]]


def _port_module(container):
    """(module name, argv) when the container runs a port module."""
    cmd = container.get("command", [])
    if cmd[:2] == ["python3", "-m"] and cmd[2].startswith(PKG + "."):
        return cmd[2][len(PKG) + 1:], cmd[3:]
    return None


def _args(container):
    module, argv = _port_module(container)
    return module, importlib.import_module(f"{PKG}.{module}").parse_args(
        argv)


def _port_containers():
    return [(n, s, c) for n, s, c in _containers() if _port_module(c)]


def _ids(items):
    return [f"{n}:{c['name']}" for n, _, c in items]


def test_every_manifest_parses_into_workloads():
    names = _manifests()
    assert len(names) >= 12
    kinds = {d["kind"] for n in names for d in _docs(n)}
    assert {"DaemonSet", "Deployment", "Service", "Job", "StatefulSet",
            "HorizontalPodAutoscaler"} <= kinds
    assert len(_port_containers()) >= 11


@pytest.mark.parametrize("item", _port_containers(),
                         ids=_ids(_port_containers()))
def test_each_port_command_parses(item):
    _, _, container = item
    _args(container)  # argparse exits on a flag it does not know


# -- (b) the LM server against the reference's manifest -----------------
def _reference_lm_env():
    with open(os.path.join(ROOT, "demo/serving/jax-serving-lm.yaml")) as f:
        for doc in yaml.safe_load_all(f):
            if doc and doc["kind"] == "Deployment":
                (server,) = doc["spec"]["template"]["spec"]["containers"]
                return {e["name"]: e["value"] for e in server["env"]}
    raise AssertionError("no Deployment in the reference's manifest")


# SERVE_* -> the port server's config field (server.py's docstring).
SERVE_FLAGS = {"SERVE_MODEL": "model", "SERVE_LM_CHECKPOINT": "checkpoint",
               "SERVE_LM_DIM": "dim", "SERVE_LM_DEPTH": "depth",
               "SERVE_LM_VOCAB": "vocab", "SERVE_LM_MAX_SEQ": "max_seq",
               "SERVE_LM_QUANT": "quant"}
QUANT_VALUES = {"1": "on", "0": "off"}


def _workload(name, obj):
    for doc in _docs(name):
        if doc["metadata"]["name"] == obj and doc["kind"] in POD_KINDS:
            return doc["spec"]["template"]["spec"]
    raise AssertionError(f"{obj} not in {name}")


def _lm_server_config():
    (server,) = _workload("serving-lm.yaml", "torch-serving-lm")[
        "containers"]
    module, cfg = _args(server)
    assert module == "server"
    return cfg


@pytest.mark.parametrize("env", sorted(_reference_lm_env()))
def test_lm_server_flags_equal_the_reference_envs(env):
    value = _reference_lm_env()[env]
    if env == "SERVE_LM_QUANT":
        value = QUANT_VALUES.get(value, value)
    assert env in SERVE_FLAGS, f"{env} has no flag mapped"
    assert str(getattr(_lm_server_config(), SERVE_FLAGS[env])) == value


def test_lm_train_job_trains_the_served_model():
    cfg = _lm_server_config()
    (train,) = _workload("serving-lm.yaml", "torch-lm-train")["containers"]
    module, args = _args(train)
    assert module == "lm_main"
    assert (args.dim, args.depth, args.vocab, args.seq_len) == (
        cfg.dim, cfg.depth, cfg.vocab, cfg.max_seq)
    assert args.model_dir == cfg.checkpoint


# -- (c) resources and node selection ------------------------------------
def _selects_gpu_nodes(spec):
    if "cloud.google.com/gke-accelerator" in spec.get("nodeSelector", {}):
        return True
    terms = (spec.get("affinity", {}).get("nodeAffinity", {})
             .get("requiredDuringSchedulingIgnoredDuringExecution", {})
             .get("nodeSelectorTerms", []))
    return any(e["key"] == "cloud.google.com/gke-accelerator"
               for t in terms for e in t.get("matchExpressions", []))


def test_pods_ask_for_gpus_on_gpu_nodes():
    for name in _manifests():
        with open(os.path.join(DEPLOY, name)) as f:
            assert "google.com/tpu" not in f.read(), name
    asking = 0
    for name, obj, spec in _pods():
        limits = [c.get("resources", {}).get("limits", {})
                  for c in spec["containers"]]
        if any("nvidia.com/gpu" in lim for lim in limits):
            asking += 1
            assert _selects_gpu_nodes(spec), (name, obj)
        if any(d for d in _docs(name) if d["kind"] == "DaemonSet"
               and d["metadata"]["name"] == obj):
            assert _selects_gpu_nodes(spec), (name, obj)
    assert asking >= 7


# -- (d) mounts ----------------------------------------------------------
def _paths(module, args):
    """The container paths the module's flags name."""
    if module == "device_plugin":
        return [args.plugin_directory, os.path.dirname(args.gpu_config),
                args.dev_directory, args.container_path, os.path.dirname(
                    args.pod_resources_socket
                    or podresources.DEFAULT_SOCKET_PATH)]
    if module == "partition":
        return [os.path.dirname(args.gpu_config),
                os.path.dirname(args.plan_file), args.dev_directory]
    if module == "server":
        return [p for p in (args.checkpoint, args.kv_disk_dir) if p]
    if module in ("resnet_main", "lm_main"):
        return [p for p in (args.model_dir,
                            getattr(args, "profile_dir", "")) if p]
    raise AssertionError(f"no path rule for {module}")


def _mounted(path, container):
    return any(path == m["mountPath"] or path.startswith(
        m["mountPath"].rstrip("/") + "/")
        for m in container.get("volumeMounts", []))


@pytest.mark.parametrize("item", _port_containers(),
                         ids=_ids(_port_containers()))
def test_every_path_a_flag_names_is_mounted(item):
    name, spec, container = item
    module, args = _args(container)
    for path in _paths(module, args):
        assert _mounted(path, container), (name, container["name"], path)
    image = IMAGE.match(container["image"]).group(1)
    if image in KERNEL_IMAGES:
        assert _mounted(KERNELS_DIR, container), (name, KERNELS_DIR)
    if module in ("device_plugin", "partition"):
        # NVML from the host's driver directory, on the loader's path.
        host = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]
                if "hostPath" in v}
        at = {m["mountPath"]: host.get(m["name"])
              for m in container["volumeMounts"]}
        lib_dir = getattr(args, "container_path", "/usr/local/nvidia")
        assert at.get(lib_dir) == getattr(
            args, "host_path", "/home/kubernetes/bin/nvidia"), (name, at)
        env = {e["name"]: e.get("value") for e in container.get("env", [])}
        assert env.get("LD_LIBRARY_PATH", "").startswith(lib_dir), name


# -- (e) images ----------------------------------------------------------
def _copy_sources(dockerfile):
    with open(os.path.join(DEPLOY, dockerfile)) as f:
        lines = f.read().replace("\\\n", " ").splitlines()
    out = []
    for line in lines:
        if not line.startswith("COPY "):
            continue
        words = shlex.split(line)
        if words:
            srcs = [w for w in words[1:-1] if not w.startswith("--")]
            assert not any(w.startswith("--from") for w in words), line
            out.extend(srcs)
    return out


def test_every_image_has_a_dockerfile_whose_sources_exist():
    images = {c["image"] for _, _, c in _containers()}
    ours = {IMAGE.match(i).group(1) for i in images if IMAGE.match(i)}
    assert images - {i for i in images if IMAGE.match(i)} <= EXTERNAL_IMAGES
    assert ours == {"gpu-device-plugin", "torch-training-demo",
                    "torch-serving-demo"}
    for image in ours:
        srcs = _copy_sources(f"{image}.Dockerfile")
        assert f"{PKG}/" in srcs, image
        for src in srcs:
            assert os.path.exists(os.path.join(ROOT, src)), (image, src)
    for _, _, c in _containers():  # scripts run by path are copied in
        cmd = c.get("command", [])
        if len(cmd) > 1 and cmd[0] == "python3" and cmd[1].startswith(APP):
            rel = os.path.relpath(cmd[1], APP)
            assert rel in _copy_sources(
                f"{IMAGE.match(c['image']).group(1)}.Dockerfile"), cmd


# -- (f) the reference's manifests ---------------------------------------
def _reference_files():
    out = [f for f in os.listdir(ROOT)
           if f.endswith(".yaml") or f == "Dockerfile"]
    for top in REFERENCE_DIRS:
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            out += [os.path.relpath(os.path.join(d, f), ROOT) for f in files
                    if f.endswith(".yaml") or f == "Dockerfile"]
    return sorted(out)


def _table():
    rows = {}
    with open(os.path.join(DEPLOY, "README.md")) as f:
        for line in f:
            m = re.match(r"^\| `([^`]+)` \| (.+) \|$", line.strip())
            if m:
                rows[m.group(1)] = m.group(2)
    return rows


def test_every_reference_manifest_is_mapped_or_not_ported():
    table = _table()
    refs = _reference_files()
    assert len(refs) >= 30
    assert sorted(table) == refs
    ported = set()
    for ref, port in table.items():
        m = re.match(r"^`([^`]+)`$", port)
        if m:
            assert os.path.exists(os.path.join(DEPLOY, m.group(1))), ref
            ported.add(m.group(1))
        else:
            assert re.match(r"^not ported: \S", port), (ref, port)
    assert set(_manifests()) <= ported
