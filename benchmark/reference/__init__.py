"""The benchmark's plain reference: a frozen copy, in plain torch, of the
port's env step (``core``, ``route_follow``, ``policy_net``, the ops, the
rasterizer's plain twin, the batched step in ``env``), which later changes
to the port do not reach. It imports nothing of the port, of the JAX
package or of JAX, and takes nothing the port has made: it loads the asset
files and the GRU's weights itself and works out again the resets, the
steps and the frames."""
