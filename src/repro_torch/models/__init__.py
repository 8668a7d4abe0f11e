"""Model definitions of the port (dense GQA so far) and the registry over them."""
