"""Both packages' Nalar serving stacks side by side, for the port's bridge,
pool and streaming tests.

A ``Stack`` is one package's runtime, bridge, pool and engine over the
qwen3-0.6b smoke config in float32; the port's weights are the JAX
package's, carried over by ``interop.params_from_numpy``.  A test runs one
scenario on each stack and holds the port's tokens and counters to the
reference's (greedy decode: the tokens must be equal).
"""

import threading
import types

import jax

import repro.configs as jcfgs
import repro.core as jcore
import repro.core.future as jfuture
import repro.core.runtime as jruntime
import repro.serving as jserving
import repro.serving.chaos as jchaos
import repro.workloads.router as jrouter
from repro.models.model import build_model as jax_build_model
import repro_torch.configs as tcfgs
import repro_torch.core as tcore
import repro_torch.core.future as tfuture
import repro_torch.core.runtime as truntime
import repro_torch.serving as tserving
import repro_torch.serving.chaos as tchaos
import repro_torch.workloads.router as trouter
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model

ARCH = "qwen3-0.6b"


class Stack(types.SimpleNamespace):
    """One package: ``core``, ``serving``, ``future``, ``chaos``, ``router``
    modules, ``current_runtime``, and the smoke model and weights."""

    def engine(self, **kw):
        return self.serving.InferenceEngine(self.model, self.params,
                                            **kw, **self.engine_kw)

    def pool_runtime(self, replicas=3, max_new_tokens=3, max_seq=64,
                     max_batch=2, **engine_kw):
        """The reference tests' pool: a quiet global policy (no default
        load-balance/HoL chain), ``replicas`` engines of ``max_batch``
        slots.  Returns (runtime, pool)."""
        rt = self.core.NalarRuntime(
            simulate=False, policy=self.core.PolicyChain(),
            nodes={"n0": {"GPU": replicas, "CPU": 8}})
        engines = [self.engine(max_batch=max_batch, max_seq=max_seq,
                               **engine_kw) for _ in range(replicas)]
        self.serving.register_engine_pool(
            rt, "llm", engines,
            sampling=self.serving.SamplingParams(
                max_new_tokens=max_new_tokens),
            resources={"GPU": 1})
        return rt, rt.engine_backends["llm"]

    def run_turn(self, rt, sid, text, **hint):
        """One ``llm.generate`` call as a request of session ``sid`` (a new
        session when None); returns its GenerationResult."""
        cur = self.current_runtime

        def driver():
            return cur().stub("llm").generate(
                text, **({"_hint": hint} if hint else {})).value(timeout=300)
        kwargs = {} if sid is None else {"session": sid}
        return self.core.deployment.main(driver, runtime=rt, **kwargs)


def run_request(rt, driver, *args, timeout=240.0):
    """Submit ``driver`` as a request on a started runtime and wait."""
    box, evt = {}, threading.Event()

    def cb(out, err):
        box["out"], box["err"] = out, err
        evt.set()
    rt.submit_request(driver, *args, on_done=cb)
    assert evt.wait(timeout), "request did not complete"
    if box["err"] is not None:
        raise box["err"]
    return box["out"]


def build_stacks():
    """(reference stack, port stack) over the same float32 smoke weights."""
    jmodel = jax_build_model(
        jcfgs.get_smoke_config(ARCH).replace(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfgs.get_smoke_config(ARCH).replace(
        dtype="float32"))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    ref = Stack(name="jax", core=jcore, serving=jserving, future=jfuture,
                chaos=jchaos, router=jrouter,
                current_runtime=jruntime.current_runtime, model=jmodel,
                params=jparams, cfg=jmodel.cfg, engine_kw={})
    port = Stack(name="torch", core=tcore, serving=tserving, future=tfuture,
                 chaos=tchaos, router=trouter,
                 current_runtime=truntime.current_runtime, model=tmodel,
                 params=tparams, cfg=tmodel.cfg,
                 engine_kw={"device": "cpu"})
    return ref, port


def same(stacks, scenario):
    """Run ``scenario(stack)`` on both stacks; the port's result must equal
    the reference's.  Returns the port's."""
    want, got = (scenario(s) for s in stacks)
    assert got == want, f"port {got!r} != reference {want!r}"
    return got
