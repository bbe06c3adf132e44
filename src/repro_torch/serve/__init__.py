# LM serving: prefill/decode steps and the slot scheduler (decode.py).
