"""The port's remote signer (`privval/remote.py`) and peer exchange
(`p2p/pex.py`), held against the JAX package on the CPU over loopback
TCP (the port's `SecretConnection` against the JAX package's):

- a `SignerClient` of either package against a `SignerServer` of either
  package, each server over its own copy of one FilePV file, signs the
  same prevote and proposal to the same bytes as the FilePV itself, and
  the signer's double-sign guard refuses a conflicting vote; a stopped
  port server and a closed port client leave no thread behind;
- address-book files are byte-identical and each package reads the
  other's; the PEX request and response messages are byte-identical;
- a port seed node, a JAX node and a port node, each dialling only the
  seed, form a full mesh through PEX, and a stopped port reactor joins
  its ensure-peers thread.

No tolerance: signatures, files and messages are compared exactly.
"""

import random
import shutil
import threading

import pytest
import torch

from _torch_node import mod, wait_for

SIDES = ("jax", "port")
CHAIN = "remote-chain"

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pv_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pv") / "pv.json")
    mod("port", "privval.file").FilePV.generate(path, random.Random(9))._save()
    return path


def _vote(side, pv_addr, block_byte: int):
    block = mod(side, "types.block")
    vote = mod(side, "types.vote")
    proto = mod(side, "types.proto")
    bid = block.BlockID(bytes([block_byte]) * 32,
                        block.PartSetHeader(1, b"\x22" * 32))
    return vote.Vote(type_=vote.PREVOTE_TYPE, height=3, round=0,
                     block_id=bid, timestamp=proto.Timestamp(50, 0),
                     validator_address=pv_addr, validator_index=0)


def _proposal(side):
    block = mod(side, "types.block")
    vote = mod(side, "types.vote")
    proto = mod(side, "types.proto")
    return vote.Proposal(height=4, round=0, pol_round=-1,
                         block_id=block.BlockID(b"\x21" * 32,
                                                block.PartSetHeader(
                                                    1, b"\x22" * 32)),
                         timestamp=proto.Timestamp(51, 0))


def _remote_signatures(tmp_path, pv_file, client_side, server_side):
    """-> (vote signature, proposal signature, the double-sign error's
    class name, pub key) through client_side's SignerClient and
    server_side's SignerServer over a fresh copy of the key file."""
    path = str(tmp_path / f"pv-{client_side}-{server_side}.json")
    shutil.copy(pv_file, path)
    pv = mod(server_side, "privval.file").FilePV.load(path)
    before = set(threading.enumerate())
    client = mod(client_side, "privval.remote").SignerClient()
    server = mod(server_side, "privval.remote").SignerServer(pv,
                                                             *client.addr)
    server.start()
    try:
        pub = client.get_pub_key().bytes_()
        vote = _vote(client_side, pv.address(), 0x21)
        client.sign_vote(CHAIN, vote)
        prop = _proposal(client_side)
        client.sign_proposal(CHAIN, prop)
        with pytest.raises(Exception) as e:
            client.sign_vote(CHAIN, _vote(client_side, pv.address(), 0x31))
    finally:
        client.close()
        server.stop()
    if client_side == server_side == "port":
        assert not [t for t in threading.enumerate() if t not in before]
    return vote.signature, prop.signature, type(e.value).__name__, pub


@pytest.mark.parametrize("client_side,server_side",
                         [("port", "jax"), ("jax", "port"),
                          ("port", "port")])
def test_remote_signer_across_packages(tmp_path, pv_file, client_side,
                                       server_side):
    got = _remote_signatures(tmp_path, pv_file, client_side, server_side)
    path = str(tmp_path / "direct.json")
    shutil.copy(pv_file, path)
    pv = mod("port", "privval.file").FilePV.load(path)
    vote = _vote("port", pv.address(), 0x21)
    pv.sign_vote(CHAIN, vote)
    prop = _proposal("port")
    pv.sign_proposal(CHAIN, prop)
    assert got == (vote.signature, prop.signature, "DoubleSignError",
                   pv.get_pub_key().bytes_())
    assert pv.get_pub_key().verify_signature(vote.sign_bytes(CHAIN),
                                             got[0])


def test_port_signer_stop_joins_its_thread(tmp_path, pv_file):
    before = set(threading.enumerate())
    pv = mod("port", "privval.file").FilePV.load(pv_file)
    remote = mod("port", "privval.remote")
    client = remote.SignerClient()
    server = remote.SignerServer(pv, *client.addr)
    server.start()
    assert client.get_pub_key().bytes_() == pv.get_pub_key().bytes_()
    server.stop()
    client.close()
    assert not [t for t in threading.enumerate() if t not in before]


# --- PEX ------------------------------------------------------------------

ENTRIES = [("aa" * 20, "127.0.0.1", 26656), ("bb" * 20, "10.0.0.2", 1),
           ("cc" * 20, "example.org", 65535)]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_address_book_files_both_ways(tmp_path, writer, reader):
    files = {}
    for side in SIDES:
        path = str(tmp_path / side / "addrbook.json")
        book = mod(side, "p2p.pex").AddressBook(path)
        for e in ENTRIES:
            book.add(*e)
        book.remove(ENTRIES[1][0])
        with open(path, "rb") as f:
            files[side] = f.read()
    assert files["port"] == files["jax"]
    back = mod(reader, "p2p.pex").AddressBook(
        str(tmp_path / writer / "addrbook.json"))
    assert sorted(back.entries()) == sorted([ENTRIES[0], ENTRIES[2]])


class _Peer:
    def __init__(self, ident):
        self.id = ident
        self.sent = []
        self.outbound = True

    def try_send(self, ch, msg):
        self.sent.append((ch, msg))
        return True


def _messages(side) -> list:
    pex = mod(side, "p2p.pex")
    book = pex.AddressBook(rng=random.Random(1))
    for e in ENTRIES:
        book.add(*e)
    r = pex.PexReactor(book)
    asker = _Peer(ENTRIES[0][0])
    r.receive(pex.PEX_CHANNEL, asker, bytes([1]))       # a request
    answer = asker.sent[-1][1]
    other = pex.PexReactor(pex.AddressBook(rng=random.Random(2)))
    other.receive(pex.PEX_CHANNEL, _Peer("dd" * 20), answer)
    return [asker.sent, pex._encode_addrs(ENTRIES),
            pex._decode_addrs(pex._encode_addrs(ENTRIES)),
            sorted(other.book.entries()), [c.id for c in r.get_channels()]]


def test_pex_messages_byte_identical():
    assert _messages("port") == _messages("jax")
    with pytest.raises(ValueError):
        mod("port", "p2p.pex").PexReactor(
            mod("port", "p2p.pex").AddressBook()).receive(
                0, _Peer("x"), bytes([9]))


def _pex_node(side, name, seed):
    keys = mod(side, "crypto.keys")
    pex = mod(side, "p2p.pex")
    key = keys.Ed25519PrivKey(bytes([seed]) * 32)
    sw = mod(side, "p2p.switch").Switch(key, "pex-net", name)
    reactor = pex.PexReactor(pex.AddressBook(), ensure_interval_s=0.2)
    reactor.attach(sw)
    sw.add_reactor(reactor)
    sw.listen()
    reactor.start()
    return sw, reactor


def test_pex_mesh_across_packages():
    """Port seed n0; a JAX node n1 and a port node n2 dial only n0. PEX
    spreads n1's and n2's addresses until each node has both others."""
    before = set(threading.enumerate())
    nodes = []
    try:
        for i, side in enumerate(("port", "jax", "port")):
            nodes.append(_pex_node(side, f"n{i}", 40 + i))
        host, port = nodes[0][0].transport.node_info.listen_addr.split(":")
        for sw, _ in nodes[1:]:
            sw.dial(host, int(port))
        wait_for(lambda: all(len(sw.peers()) >= 2 for sw, _ in nodes),
                 "a full mesh through PEX", deadline_s=30)
        for _sw, reactor in nodes:
            assert len(reactor.book) >= 2
    finally:
        for sw, reactor in nodes:
            reactor.stop()
            sw.stop()
    # the port's reactors and switches joined their threads; what is
    # left belongs to the JAX package's node
    left = [t for t in threading.enumerate()
            if t not in before and t.name == "pex-ensure"]
    assert len(left) <= 1
