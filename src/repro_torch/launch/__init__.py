"""Entry points of the port: training (:mod:`.train`) and serving (:mod:`.serve`)."""
