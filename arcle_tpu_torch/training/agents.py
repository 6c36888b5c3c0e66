"""Policy-agnostic agent interface for the rollout, PPO and E-MAML
machinery.

Counterpart of ``arcle_tpu/training/agents.py``.  An :class:`Agent`
packages functions over a flat observation vector, so the learners never
care which network is behind them.  ``params`` is either the policy
``nn.Module`` itself (the PPO learner) or a mapping from parameter names
to tensors, which runs the agent's module through
``torch.func.functional_call`` (E-MAML's per-task parameters):

* ``obs_fn(env_state) -> obs``                    batched observations
* ``sample_fn(params, obs, generator, deterministic=False, u=None)
  -> (actions [..., 5], log_prob, value)``; ``u`` injects the uniforms
* ``evaluate_fn(params, obs, actions) -> (log_prob, value, entropy)``
* ``init_fn(generator) -> params``                a freshly initialised policy
* ``aux_fn(params, obs, actions) -> {"rtm1", "r", "g_logits"}`` (GPT only)

``sample_fn`` draws its uniforms from ``generator`` first and hands them
to a forward that draws nothing; that forward and ``evaluate_fn``'s run
through :class:`PolicyGraphs`, which replays them as CUDA graphs where it
can see that this is safe.

:func:`mlp_agent` is the FilterO2ARC MLP pipeline (train.py:62-68);
:func:`gpt_agent` the transformer over the full observation with the
categorical op + truncated-normal bbox head (train_gpt.py, bboxdist.py).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import weakref
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn.modules import module as _module

from ..models import bbox_dist
from ..models.gpt import GPTPolicy
from ..models.mlp import (
    FCPolicy, multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy, multi_categorical_uniforms,
    stack_padded_logits,
)
from ..utils.metrics import TRACE
from ..wrappers import flatten_obs, full_flatten_obs, unflatten_full, \
    FULL_OBS_DIM


@dataclasses.dataclass(frozen=True)
class Agent:
    obs_fn: Callable
    sample_fn: Callable
    evaluate_fn: Callable
    init_fn: Callable          # (generator) -> params
    obs_dim: int
    # optional action-conditioned auxiliary predictions
    # (params, obs, actions) -> {"rtm1", "r", "g_logits"}; used by
    # ppo_loss when aux_coeff > 0 (paper §4.1.1 losses)
    aux_fn: Optional[Callable] = None
    # the CUDA graphs of sample_fn's and evaluate_fn's no-grad forwards
    graphs: Optional["PolicyGraphs"] = None


def apply(module: nn.Module, params, *args, **kwargs):
    """``module(*args, **kwargs)`` with ``params``: the module itself, or
    a name -> tensor mapping that stands in for its parameters."""
    if isinstance(params, nn.Module):
        return params(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


class _Graph:
    """A captured call: its static inputs, where each call's inputs are
    copied, and its static outputs."""

    __slots__ = ("graph", "inputs", "outputs")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


_WARM = object()    # a key's state between its warm-up and its capture


def _addresses(module: nn.Module, out: list) -> bool:
    """Append the address of every parameter and buffer of ``module``'s
    tree to ``out``; False where a module of it has a forward hook, which a
    replay would skip."""
    if module._forward_hooks or module._forward_pre_hooks:
        return False
    out += [t.data_ptr() for t in module._parameters.values()
            if t is not None]
    out += [t.data_ptr() for t in module._buffers.values() if t is not None]
    return all(_addresses(m, out) for m in module._modules.values()
               if m is not None)


class PolicyGraphs:
    """CUDA graphs of an agent's policy calls.

    ``wrap(core)`` gives ``call(params, *tensors, **flags)``, which runs
    ``core(params, *tensors, **flags)``: a function of its arguments alone
    that draws no random numbers and returns a tuple of tensors.  The call
    is replayed from a CUDA graph only where it can see that a graph is
    safe: ``params`` is the ``nn.Module`` itself with no forward hooks,
    the tensors (None allowed) lie on CUDA, gradients are off, and no
    autocast, dispatch mode, function mode or global module hook is on.
    Everything else, the CPU, the learner under grad and a name -> tensor
    mapping, runs ``core`` as it is.

    A key is the module, the tensors' shapes, strides, dtypes and device,
    the flags, the addresses of the module's parameters and buffers,
    inference mode and the float32 matmul precision.  A key's first call
    runs eagerly on a side stream (the warm-up), its second captures the
    graph, and every later one replays it: the tensors are copied into the
    graph's static inputs, parameters are read where they lie (Adam and
    ``load_state_dict`` write in place; a parameter moved or rebound
    changes the key) and the outputs come back as clones, which the caller
    owns.  Each replay is a ``policy_graph`` span.  A module keeps its
    ``MAX_KEYS`` most recent keys a core (the cells use two a module:
    sampling and evaluating, or greedy and sampling); ``captures`` and
    ``replays`` count."""

    MAX_KEYS = 8

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._streams = {}

    def wrap(self, core: Callable) -> Callable:
        keys = weakref.WeakKeyDictionary()  # module -> key -> state

        def call(params, *tensors, **flags):
            key = self._key(params, tensors, flags)
            if key is None:
                return core(params, *tensors, **flags)
            per = keys.setdefault(params, collections.OrderedDict())
            state = per.get(key)
            if state is None:
                per[key] = _WARM
                if len(per) > self.MAX_KEYS:
                    per.popitem(last=False)
                return self._warm_up(core, params, tensors, flags)
            per.move_to_end(key)
            if state is _WARM:
                state = per[key] = self._capture(core, params, tensors,
                                                 flags)
            with TRACE.span("policy_graph"):
                for dst, src in zip(state.inputs, tensors):
                    if dst is not None:
                        dst.copy_(src)
                state.graph.replay()
                self.replays += 1
                return tuple(o.clone() for o in state.outputs)

        return call

    @staticmethod
    def _key(params, tensors, flags):
        """The call's key, or None where it runs eagerly."""
        if (not isinstance(params, nn.Module) or torch.is_grad_enabled()
                or any(t is not None and not t.is_cuda for t in tensors)
                or torch.is_autocast_enabled("cuda")
                or torch._C._len_torch_dispatch_stack()
                or torch._C._is_torch_function_mode_enabled()
                or _module._global_forward_hooks
                or _module._global_forward_pre_hooks):
            return None
        addresses = []
        if not _addresses(params, addresses):
            return None
        return (tuple(None if t is None else
                      (t.shape, t.stride(), t.dtype, t.device)
                      for t in tensors),
                tuple(flags.items()), tuple(addresses),
                torch.is_inference_mode_enabled(),
                torch.get_float32_matmul_precision())

    def _warm_up(self, core, params, tensors, flags):
        """``core`` eagerly on this object's side stream of the device (one
        stream, so a block the warm-up's outputs leave is taken again only
        by a later warm-up, after its wait on the caller's stream)."""
        dev = next(t for t in tensors if t is not None).device
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        caller = torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = core(params, *tensors, **flags)
        caller.wait_stream(side)
        return out

    def _capture(self, core, params, tensors, flags) -> _Graph:
        dev = next(t for t in tensors if t is not None).device
        inputs = tuple(None if t is None else t.clone() for t in tensors)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            outputs = core(params, *inputs, **flags)
        self.captures += 1
        return _Graph(graph, inputs, outputs)


def mlp_agent(policy: FCPolicy) -> Agent:
    graphs = PolicyGraphs()

    def sample_core(params, obs, u, deterministic):
        logits_tuple, value = apply(policy, params, obs)
        if deterministic:
            acts = torch.argmax(stack_padded_logits(logits_tuple),
                                dim=-1).to(torch.int32)
            lp = multi_categorical_log_prob(logits_tuple, acts)
        else:
            acts, lp = multi_categorical_sample(logits_tuple, u=u)
        return acts, lp, value

    def evaluate_core(params, obs, actions):
        logits_tuple, value = apply(policy, params, obs)
        lp = multi_categorical_log_prob(logits_tuple, actions)
        ent = multi_categorical_entropy(logits_tuple)
        return lp, value, ent

    sample, evaluate = graphs.wrap(sample_core), graphs.wrap(evaluate_core)

    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        with TRACE.span("policy"):
            if deterministic:
                u = None
            elif u is None:
                u = multi_categorical_uniforms(policy.sizes, obs.shape[:-1],
                                               generator, obs.device)
            return sample(params, obs, u, deterministic=deterministic)

    def evaluate_fn(params, obs, actions):
        with TRACE.span("policy"):
            return evaluate(params, obs, actions)

    def init_fn(generator: Optional[torch.Generator] = None) -> FCPolicy:
        fresh = copy.deepcopy(policy)
        fresh.reset_parameters(generator)
        return fresh

    return Agent(obs_fn=flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=policy.obs_dim, graphs=graphs)


def gpt_agent(model: GPTPolicy, grid_size: int = 30) -> Agent:
    """The op + bbox distribution math lives in :mod:`models.bbox_dist`.
    ``u`` of ``sample_fn`` is ``(u_op, u_bbox)``."""

    graphs = PolicyGraphs()

    def forward(params, obs, **kw):
        f = unflatten_full(obs)
        return apply(model, params, f["grid"], f["grid_dim"], f["input"],
                     f["input_dim"], f["trials_remain"], f["active"], **kw)

    def sample_core(params, obs, u_op, u_bbox, deterministic):
        out = forward(params, obs)
        s = bbox_dist.sample(out["op_logits"], out["bbox_mean_all"],
                             out["bbox_std_all"], grid_size, deterministic,
                             u_op=u_op, u_bbox=u_bbox)
        acts = torch.cat([s.bbox, s.operation[..., None]], dim=-1)
        return acts, s.log_prob, out["value"]

    def evaluate_core(params, obs, actions):
        out = forward(params, obs)
        op = actions[..., 4]
        lp = bbox_dist.log_prob(out["op_logits"], out["bbox_mean_all"],
                                out["bbox_std_all"], op, actions[..., :4],
                                grid_size)
        ent = bbox_dist.entropy(out["op_logits"], out["bbox_mean_all"],
                                out["bbox_std_all"], op)
        return lp, out["value"], ent

    sample, evaluate = graphs.wrap(sample_core), graphs.wrap(evaluate_core)

    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        with TRACE.span("policy"):
            u_op = u_bbox = None
            if not deterministic:
                u_op, u_bbox = bbox_dist.draw_uniforms(
                    obs.shape[:-1], model.cfg.num_actions, generator,
                    obs.device, u=u)
            return sample(params, obs, u_op, u_bbox,
                          deterministic=deterministic)

    def evaluate_fn(params, obs, actions):
        with TRACE.span("policy"):
            return evaluate(params, obs, actions)

    def aux_fn(params, obs, actions):
        """The action-conditioned forward (GPTPolicy.py:401-456 intent):
        r_t and next-grid predictions, and r_{t-1} from the same pass's
        CLS (pre-action information, so conditioning is harmless)."""
        out = forward(params, obs, operation=actions[..., 4],
                      bbox=actions[..., :4].to(torch.float32) / grid_size)
        return {"rtm1": out["aux_rtm1"], "r": out["aux_reward"],
                "g_logits": out["aux_transition"]}

    def init_fn(generator: Optional[torch.Generator] = None) -> GPTPolicy:
        return GPTPolicy(model.cfg, generator)

    return Agent(obs_fn=full_flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=FULL_OBS_DIM, aux_fn=aux_fn, graphs=graphs)
