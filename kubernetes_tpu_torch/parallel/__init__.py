"""Multi-device execution of the port: node-axis sharding over a mesh of
torch devices (`sharding.py`)."""
