"""Single-file interactive scene viewer: the pyviz3d-bundle equivalent.

The reference saves pyviz3d bundles per scene (models/evaluation.py:605-615)
— a small web app with toggleable point layers (input RGB / pred + GT
instances + semantics) and GT bounding-box line sets. pyviz3d is not in this
environment's dependency set, so this module writes the same artifact as ONE
self-contained `viewer.html`: raw WebGL1 (no external JS, no CDN — the file
works offline), orbit controls, per-layer visibility checkboxes, and a point
size slider. Geometry is embedded as base64 of the raw little-endian buffers;
all point layers share one position buffer so N extra layers only cost N
color buffers.

The port's copy of box2mask_tpu/viz/html_viewer.py: it writes the same
bytes.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode('ascii')


def write_html_viewer(path, positions, point_layers, line_layers=(),
                      max_points=400_000, point_size=3.0,
                      title='box2mask-tpu scene'):
    """Write a self-contained interactive HTML viewer.

    positions: (N, 3) float array shared by every point layer.
    point_layers: iterable of (name, colors(N,3) uint8-ish, visible: bool).
    line_layers: iterable of (name, starts(M,3), ends(M,3),
                 colors-per-segment(M,3) uint8-ish, visible: bool).
    Scenes above max_points are deterministically subsampled (seed 0) —
    the interactive artifact is for inspection, the PLYs stay full-res.
    """
    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    n = len(pos)
    keep = None
    if n > max_points:
        keep = np.random.default_rng(0).choice(n, max_points, replace=False)
        keep.sort()
        pos = pos[keep]
    center = pos.mean(axis=0) if len(pos) else np.zeros(3, np.float32)
    pos = pos - center  # float32 precision + orbit pivot at the centroid
    radius = float(np.abs(pos).max()) if len(pos) else 1.0

    players = []
    for name, colors, visible in point_layers:
        c = np.clip(np.asarray(colors, np.float64), 0, 255).astype(np.uint8)
        c = c.reshape(-1, 3)
        if len(c) != n:
            raise ValueError(f'layer {name!r}: {len(c)} colors, {n} points')
        if keep is not None:
            c = c[keep]
        players.append({'name': str(name), 'visible': bool(visible),
                        'colors': _b64(c)})

    llayers = []
    for name, starts, ends, colors, visible in line_layers:
        s = np.asarray(starts, np.float32).reshape(-1, 3) - center
        e = np.asarray(ends, np.float32).reshape(-1, 3) - center
        c = np.clip(np.asarray(colors, np.float64), 0, 255).astype(np.uint8)
        c = c.reshape(-1, 3)
        verts = np.empty((2 * len(s), 3), np.float32)
        verts[0::2], verts[1::2] = s, e
        vc = np.repeat(c, 2, axis=0)
        llayers.append({'name': str(name), 'visible': bool(visible),
                        'verts': _b64(verts), 'colors': _b64(vc),
                        'count': int(2 * len(s))})

    data = {'n': int(len(pos)), 'positions': _b64(pos), 'points': players,
            'lines': llayers, 'radius': radius, 'pointSize': float(point_size),
            'title': str(title)}
    html = _TEMPLATE.replace('__DATA__', json.dumps(data))
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>box2mask-tpu viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;
  font:13px system-ui,sans-serif}
 #c{width:100%;height:100%;display:block}
 #ui{position:fixed;top:10px;left:10px;background:rgba(20,20,24,.85);
  color:#ddd;padding:10px 14px;border-radius:8px;user-select:none;
  max-height:92vh;overflow:auto}
 #ui h3{margin:0 0 6px;font-size:13px;color:#fff}
 #ui label{display:block;margin:3px 0;cursor:pointer}
 #ui .hint{color:#888;margin-top:8px;font-size:11px}
 input[type=range]{width:120px;vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas><div id="ui"><h3 id="title"></h3></div>
<script id="scene-data" type="application/json">__DATA__</script>
<script>
"use strict";
const D = JSON.parse(document.getElementById('scene-data').textContent);
document.getElementById('title').textContent = D.title;
function buf(b64, T){const s=atob(b64),u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl',{antialias:true});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);
 gl_PointSize=clamp(ps*40.0/gl_Position.w,1.0,40.0);vc=col/255.0;}`;
const FS=`precision mediump float;varying vec3 vc;uniform float round_pt;
void main(){
 if(round_pt>0.5){vec2 d=gl_PointCoord-vec2(0.5);
  if(dot(d,d)>0.25)discard;}
 gl_FragColor=vec4(vc,1.0);}`;
function shader(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
  throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const loc={p:gl.getAttribLocation(prog,'p'),
 col:gl.getAttribLocation(prog,'col'),
 mvp:gl.getUniformLocation(prog,'mvp'),
 ps:gl.getUniformLocation(prog,'ps'),
 round:gl.getUniformLocation(prog,'round_pt')};
function glbuf(arr){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,arr,gl.STATIC_DRAW);return b;}
const posBuf=glbuf(buf(D.positions,Float32Array));
const layers=[];
for(const L of D.points)layers.push({name:L.name,on:L.visible,kind:'pts',
 pos:posBuf,col:glbuf(buf(L.colors,Uint8Array)),count:D.n});
for(const L of D.lines)layers.push({name:L.name,on:L.visible,kind:'lines',
 pos:glbuf(buf(L.verts,Float32Array)),col:glbuf(buf(L.colors,Uint8Array)),
 count:L.count});
// ---- UI ----
const ui=document.getElementById('ui');
for(const L of layers){const l=document.createElement('label');
 const cb=document.createElement('input');cb.type='checkbox';cb.checked=L.on;
 cb.onchange=()=>{L.on=cb.checked;};
 l.appendChild(cb);l.appendChild(document.createTextNode(' '+L.name));
 ui.appendChild(l);}
const sz=document.createElement('label');
sz.innerHTML='point size <input id="psz" type="range" min="0.5" max="12" step="0.5">';
ui.appendChild(sz);const psz=document.getElementById('psz');
psz.value=D.pointSize;
const hint=document.createElement('div');hint.className='hint';
hint.textContent='drag: rotate - wheel: zoom - shift/right-drag: pan';
ui.appendChild(hint);
// ---- matrices ----
function persp(f,a,n,fr){const t=1/Math.tan(f/2);
 return [t/a,0,0,0, 0,t,0,0, 0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0];}
function mul(a,b){const o=new Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function lookAt(e,t,up){
 let z=[e[0]-t[0],e[1]-t[1],e[2]-t[2]];let zl=Math.hypot(...z);
 z=z.map(v=>v/zl);
 let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 let xl=Math.hypot(...x);x=x.map(v=>v/xl);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
  -(x[0]*e[0]+x[1]*e[1]+x[2]*e[2]),
  -(y[0]*e[0]+y[1]*e[1]+y[2]*e[2]),
  -(z[0]*e[0]+z[1]*e[1]+z[2]*e[2]),1];}
// ---- orbit state ----
let theta=0.6,phi=1.0,rad=D.radius*2.5,target=[0,0,0];
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2};e.preventDefault();});
window.addEventListener('mouseup',()=>drag=null);
canvas.addEventListener('contextmenu',e=>e.preventDefault());
window.addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=rad*0.0015;   // z-up: camera right is in the xy plane
  const rx=-Math.sin(theta),ry=Math.cos(theta);
  target[0]-=s*dx*rx;target[1]-=s*dx*ry;target[2]+=s*dy;}
 else{theta-=dx*0.006;phi=Math.min(3.05,Math.max(0.05,phi-dy*0.006));}});
canvas.addEventListener('wheel',e=>{rad*=Math.exp(e.deltaY*0.0012);
 e.preventDefault();},{passive:false});
// z-up scenes: map data (x,y,z) -> view with y up by orbiting around z
function eye(){return [target[0]+rad*Math.sin(phi)*Math.cos(theta),
 target[1]+rad*Math.sin(phi)*Math.sin(theta),target[2]+rad*Math.cos(phi)];}
function draw(){
 const w=canvas.clientWidth,h=canvas.clientHeight;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.07,0.07,0.08,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const P=persp(0.9,w/h,D.radius*0.01,D.radius*40);
 const V=lookAt(eye(),target,[0,0,1]);
 const MVP=mul(P,V);
 gl.uniformMatrix4fv(loc.mvp,false,new Float32Array(MVP));
 gl.uniform1f(loc.ps,parseFloat(psz.value));
 for(const L of layers){if(!L.on||!L.count)continue;
  gl.uniform1f(loc.round,L.kind==='pts'?1.0:0.0);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.pos);
  gl.enableVertexAttribArray(loc.p);
  gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.col);
  gl.enableVertexAttribArray(loc.col);
  gl.vertexAttribPointer(loc.col,3,gl.UNSIGNED_BYTE,false,0,0);
  gl.drawArrays(L.kind==='pts'?gl.POINTS:gl.LINES,0,L.count);}
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
</script></body></html>
"""
