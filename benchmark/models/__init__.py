"""One module per configuration, found by the configuration's name: its
FLOPs per forward, counted from the layer shapes in its file, its weights
(read from the committed file or drawn from the seed on the device), and
its plain float32 reference forward. Nothing here imports the program."""
