"""JSON-RPC wire pieces the light client needs: the client's error and the
JSON codecs of headers, commits and validator sets (from the JAX
package's `rpc/client.py` and `rpc/codec.py`). The HTTP client, the proof
codecs and the server are not ported yet (ROADMAP.md Queue 1: the
host-only layers)."""
