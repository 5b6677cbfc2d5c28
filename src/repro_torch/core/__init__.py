"""Transform math, plans and quantization of the port."""
