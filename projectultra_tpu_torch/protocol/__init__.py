"""Host-side protocol stack of the PyTorch port: frames, ARQ, connection,
files, compression (copies of the JAX package's modules) and the
``ProtocolEngine`` that drives the port's ``ModemEngine``."""

from . import frame_v2
from .arq import ARQConfig, ARQMode, StopAndWaitARQ, SelectiveRepeatARQ, create_arq
from .connection import Connection, ConnectionConfig, ConnectionState
from .file_transfer import FileTransferController
from . import compression
