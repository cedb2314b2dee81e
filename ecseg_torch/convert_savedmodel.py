"""Convert a TF-Keras SavedModel (the reference's ``interseg_models/interseg``
and ``interseg_models/ecseg_c``, loaded at reference src/utils.py:27-33)
into the legacy Keras ``.h5`` that ``pipelines/interseg.load_classifier_models``
and ``models/keras_import.import_keras_h5`` read, with no TensorFlow.  The
counterpart of ``scripts/convert_savedmodel.py``::

    python -m ecseg_torch.convert_savedmodel SAVEDMODEL_DIR OUT_H5

It reads two files of the SavedModel and nothing else:

- ``keras_metadata.pb``: the root node's ``model_config`` (the model's
  ``get_config()``, as the ``.h5`` holds it once Keras's SavedModel
  encoding is undone: ``{"class_name": "__tuple__", "items": [...]}``
  back to lists, every ``shared_object_id`` dropped), its
  ``keras_version`` and ``backend``, and each node's ``node_path`` and
  metadata ``name`` (the layer names).  TF-Keras 2.8 and 2.21 write all of
  these keys.
- ``variables/variables.{index,data-*}`` through ``core/tfbundle.py``:
  the checkpoint's object graph (``_CHECKPOINTABLE_OBJECT_GRAPH``) leads
  from a node's path (``root.layer_with_weights-3``) to the layer's object,
  whose ``variables`` and ``trainable_variables`` lists give its weights,
  their names (``conv/kernel``; a nested model's are its layers') and
  their checkpoint keys.

Each of the root's layers (``model.layers``: a Sequential's InputLayer is
not one) gets a group of its weights in Keras's ``.h5`` order, the trainable
ones first, so a nested model's layers are laid out as ``model.save(...,
save_format="h5")`` lays them out.  Not written: ``training_config`` and
the optimizer's weights, which no loader of this repository reads.  A
SavedModel without ``keras_metadata.pb``, or whose root has no
``model_config`` (a subclassed model), raises ``ValueError``: Keras cannot
write it to ``.h5`` either.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List

from .core.hdf5 import write_keras_h5
from .core.tfbundle import CheckpointReader, fields, first, object_graph


def read_metadata(path: str) -> List[Dict]:
    """``keras_metadata.pb`` (a ``SavedMetadata``): one dict a node, its
    ``path`` and ``metadata`` (the decoded JSON)."""
    with open(path, "rb") as f:
        msg = fields(f.read())
    nodes = []
    for raw in msg.get(1, []):
        node = fields(raw)
        nodes.append({"path": first(node, 3, b"").decode(), "metadata": json.loads(first(node, 5, b"{}").decode() or "{}")})
    return nodes


def decode_config(value):
    """A config as Keras's SavedModel encoding stores it, back to the form
    ``model.get_config()`` serializes to in an ``.h5``."""
    if isinstance(value, dict):
        if value.get("class_name") == "__tuple__" and set(value) == {"class_name", "items"}:
            return [decode_config(v) for v in value["items"]]
        return {k: decode_config(v) for k, v in value.items() if k != "shared_object_id"}
    if isinstance(value, list):
        return [decode_config(v) for v in value]
    return value


class _Graph:
    """The checkpoint's object graph, walked by the nodes' local names."""

    def __init__(self, reader: CheckpointReader):
        self.reader = reader
        self.nodes = object_graph(reader)

    def children(self, node: int) -> Dict[str, int]:
        return dict(self.nodes[node]["children"])

    def resolve(self, path: str) -> int:
        """The node of a metadata path (``root.layer_with_weights-3``)."""
        node = 0
        for part in path.split(".")[1:]:
            kids = self.children(node)
            if part not in kids:
                raise ValueError(f"{path}: no object {part!r} in the checkpoint's object graph")
            node = kids[part]
        return node

    def variable(self, node: int):
        """(weight name, checkpoint key) of a variable's node, else None."""
        for name, full_name, key in self.nodes[node]["attributes"]:
            if name == "VARIABLE_VALUE":
                return full_name, key
        return None

    def listed(self, node: int, attr: str) -> List[int]:
        """The nodes of a layer's list attribute (``variables``), in order."""
        kids = self.children(node)
        if attr not in kids:
            return []
        return [i for _, i in sorted(self.children(kids[attr]).items(), key=lambda kv: int(kv[0]))]

    def layer_weights(self, node: int, layer: str) -> Dict[str, object]:
        """Keras weight name (``conv/kernel:0``) -> array, in ``.h5`` order:
        the trainable variables, then the others.  A layer object with no
        ``variables`` list (an InputLayer) holds none."""
        if "variables" not in self.children(node):
            if any(self.variable(i) for i in self.children(node).values()):
                raise NotImplementedError(f"layer {layer!r} holds variables but no variables list to order them")
            return {}
        trainable = self.listed(node, "trainable_variables")
        out = {}
        for i in trainable + [i for i in self.listed(node, "variables") if i not in trainable]:
            full_name, key = self.variable(i)
            out[f"{full_name}:0"] = self.reader.get_tensor(key)
        return out


def convert(savedmodel_dir: str, out_h5: str) -> None:
    meta_path = os.path.join(savedmodel_dir, "keras_metadata.pb")
    if not os.path.exists(meta_path):
        raise ValueError(f"{savedmodel_dir} has no keras_metadata.pb: not a Keras SavedModel, and only a Keras model "
                         "can be written as a Keras .h5")
    nodes = read_metadata(meta_path)
    root = next((n["metadata"] for n in nodes if n["path"] == "root"), None)
    if not root or not root.get("model_config"):
        raise ValueError(f"{savedmodel_dir}: the root's metadata holds no model_config (a subclassed model, whose "
                         "architecture is code): Keras cannot write it as an .h5 either")
    config = decode_config(root["model_config"])
    graph = _Graph(CheckpointReader(os.path.join(savedmodel_dir, "variables", "variables")))
    names = {graph.resolve(n["path"]): n["metadata"]["name"] for n in nodes
             if n["path"].startswith("root.layer") and "name" in n["metadata"]}
    layers = sorted(((int(k[len("layer-"):]), i) for k, i in graph.children(0).items() if k.startswith("layer-")))
    layer_names = [names[i] for _, i in layers]
    weights = {names[i]: graph.layer_weights(i, names[i]) for _, i in layers}
    write_keras_h5(out_h5, config, weights, layer_names, keras_version=root.get("keras_version", "2.8.0"),
                   backend=root.get("backend", "tensorflow"))
    print(f"wrote {out_h5}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m ecseg_torch.convert_savedmodel SAVEDMODEL_DIR OUT_H5", file=sys.stderr)
        return 2
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
