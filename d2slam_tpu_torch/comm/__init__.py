from d2slam_tpu_torch.comm.codec import (
    RemoteKeyframePacket,
    encode_keyframe,
    decode_keyframe,
)
from d2slam_tpu_torch.comm.transport import UDPMulticastTransport
