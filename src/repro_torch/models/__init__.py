# The LM serving path's model: parameter specs and init (param.py), the
# layers (layers.py), the stack and its caches (transformer.py), LModel
# (model.py) and the converter from the JAX package's trees (convert.py).
